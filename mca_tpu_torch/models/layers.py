"""Fusion-transformer primitives, ported from ``mca_tpu/models/layers.py``.

- :class:`LayerNorm` — bias-less (learnable ``gamma``), fp32, eps 1e-6.
- :class:`FeedForward` — GEGLU MLP, ``inner = int(dim * mult * 2/3)``,
  bias-free, exact (erf) GELU.  ``fused=True`` (the forward-only entry
  points, as the JAX package's ``MCA_FUSED_FF`` on serve / infer) goes
  through the fused op (:func:`mca_tpu_torch.ops.fused_ff.geglu_ff`:
  the Hopper kernel on CUDA, its plain version on the CPU) and refuses
  to run where autograd would need its weights' gradients;
  ``fused=False`` (training) is the differentiable linear -> gelu ->
  linear chain, run at the inner width padded to a multiple of 64;
  ``quant="int8"`` (serving) the unpadded chain over int8 weights
  (:mod:`mca_tpu_torch.ops.quant`).
- :class:`Attention` — MHA with a fused ``to_kv`` projection (k the
  first half), cross-attention through ``context`` (the attentive
  pool), and the static / dynamic mask pair; int8 projections with
  ``quant="int8"``; ``return_attn=True`` (here and on
  :class:`MCALayer`) also returns the post-softmax probabilities.  With a ``model_group`` of several ranks it is
  tensor-parallel by heads (:mod:`mca_tpu_torch.parallel.sharding`):
  the rank holds ``heads / model`` heads, its input passes Megatron's
  ``copy_to_model`` (or, under ``seq_shard``, the all-gather of the
  sequence shards) and its output projection's partials are summed in
  fp32 by ``reduce_from_model`` (or reduce-scattered back to shards).
- :class:`MCALayer` — one shared norm, residuals around the *normed*
  activations: ``x = norm(x); x = attn(x) + x; x = norm(x);
  x = ff(x) + x``; with ``moe_experts > 0`` the feed-forward is
  :class:`~mca_tpu_torch.models.moe.MoEFeedForward`, routed under the
  padding mask (its experts split over ``model`` where they divide).

- :class:`DecoderBlock` — DeepSeek-V3's decoder block (the ``deepseek_v3``
  block of the MCA stack, no JAX counterpart): two RMSNorms and
  residuals around the sublayers on the fp32 stream, latent attention
  (:mod:`mca_tpu_torch.models.mla`) and a SwiGLU or the routed and
  shared experts (:mod:`mca_tpu_torch.models.routed_moe`).

dtype chain (as in the JAX package): the norm returns fp32; attention
and FF cast their input to the compute dtype; their outputs are cast
back to the residual's dtype.  Parameters stay fp32 and are cast at use.
Parameter names are the torch reference's (``to_q.weight``,
``feedforward.0.weight``, ``norm.gamma``, ...).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mca_tpu_torch.encoders import LN_EPS
from mca_tpu_torch.models.moe import MoEFeedForward
from mca_tpu_torch.ops.attention import dense_masked_attention, masked_attention
from mca_tpu_torch.ops.fused_ff import (
    geglu_ff,
    padded_columns,
    padded_halves,
    prepare_geglu_weights,
)
from mca_tpu_torch.ops.quant import QUANT_MODES, QuantLinear
from mca_tpu_torch.parallel import collectives as coll


class LayerNorm(nn.Module):
    """Bias-less layernorm computed in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), (x.shape[-1],), self.gamma, None, LN_EPS
        )


class FeedForward(nn.Module):
    """GEGLU feed-forward: fused (forward only), unfused, or int8.

    ``feedforward.0`` is W1 ``[2*inner, dim]`` (u half first),
    ``feedforward.2`` is W2 ``[dim, inner]``; index 1 stands for the
    reference's parameter-free GEGLU.  On the fused path the transposed,
    interleaved, padded compute-dtype copies the op takes are the
    non-persistent buffers ``w1t`` / ``w2t``, remade by an eager call
    only when a weight's storage or version changed, and read as they
    stand by a traced one (``torch.export``), so they must have been
    made by one eager call before tracing.  They are detached, so that
    path raises when grad mode is on and a weight requires grad, instead
    of leaving the weights without gradients.  The unfused path casts
    the weights into zero-padded copies at the inner width rounded up to
    a multiple of 64 (1365 -> 1408), with ``prepare_geglu_weights``' own
    padding, and runs u and the gate as two products: every product's
    operands then have leading dimensions that are multiples of 64
    (cuBLAS's Hopper kernels need 16-byte-aligned strides), and the
    gate's GELU and the product run on contiguous halves.  The padded
    columns are exact zeros (u = g = 0, GELU(0) * 0 = 0, and W2's zero
    columns meet them), the parameters keep their shapes, and autograd
    carries the gradients back through the pad as a slice.
    ``quant="int8"`` holds the two matrices as
    :class:`~mca_tpu_torch.ops.quant.QuantLinear` (``weight_q`` /
    ``scale``) and runs the unpadded chain over them, as the JAX package
    does.
    """

    def __init__(
        self,
        dim: int,
        mult: float = 4,
        dtype: torch.dtype = torch.float32,
        quant: str = "none",
        fused: bool = True,
    ):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        inner = int(dim * mult * 2 / 3)
        self.quant = quant
        if quant == "int8":
            lin1 = QuantLinear(dim, inner * 2, dtype)
            lin2 = QuantLinear(inner, dim, dtype)
        else:
            lin1 = nn.Linear(dim, inner * 2, bias=False)
            lin2 = nn.Linear(inner, dim, bias=False)
        self.feedforward = nn.ModuleList([lin1, nn.Identity(), lin2])
        self.dtype = dtype
        self.fused = fused and quant == "none"
        if self.fused:
            self.register_buffer("w1t", torch.empty(0), persistent=False)
            self.register_buffer("w2t", torch.empty(0), persistent=False)
        self._prepared_key = None

    def _weights(self):
        if not torch.compiler.is_compiling():
            w1 = self.feedforward[0].weight
            w2 = self.feedforward[2].weight
            key = (w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
            if key != self._prepared_key:
                # plain tensors even under inference_mode, so that a
                # later trace can take them
                with torch.inference_mode(False), torch.no_grad():
                    self.w1t, self.w2t = prepare_geglu_weights(
                        w1.t(), w2.t(), self.dtype
                    )
                self._prepared_key = key
        return self.w1t, self.w2t

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.quant == "int8":
            h, gate = self.feedforward[0](x).chunk(2, dim=-1)
            return self.feedforward[2](F.gelu(gate, approximate="none") * h)
        if self.fused:
            if torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters()
            ):
                raise RuntimeError(
                    "the fused GEGLU feed-forward is forward-only: build "
                    "the model with fused_ff=False to train, or run under "
                    "torch.no_grad() / inference_mode()"
                )
            return geglu_ff(x.contiguous(), *self._weights())
        w1 = self.feedforward[0].weight
        w2 = self.feedforward[2].weight
        w1p = padded_halves(w1, self.dtype)
        u = F.linear(x, w1p[0])
        g = F.linear(x, w1p[1])
        return F.linear(
            F.gelu(g, approximate="none") * u, padded_columns(w2, self.dtype)
        )


class Attention(nn.Module):
    """Multi-head attention; ``attn_mask`` static ``[Tq, Tk]`` (True =
    blocked), ``key_padding_mask`` ``[B, Tk]`` (True = padded).
    ``quant="int8"`` makes ``to_q``, ``to_kv`` and ``to_out``
    :class:`~mca_tpu_torch.ops.quant.QuantLinear`; the attention itself
    is unchanged (the flash kernel on the flash path)."""

    def __init__(
        self,
        dim: int,
        dim_head: int = 64,
        heads: int = 8,
        dtype: torch.dtype = torch.float32,
        impl: str = "dense",
        quant: str = "none",
        model_group=None,
        seq_shard: bool = False,
    ):
        super().__init__()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        m = coll.group_size(model_group)
        if heads % m:
            raise ValueError(f"heads={heads} do not split over mesh_model={m}")
        heads //= m
        inner = dim_head * heads
        if quant == "int8":
            self.to_q = QuantLinear(dim, inner, dtype)
            self.to_kv = QuantLinear(dim, inner * 2, dtype)
            self.to_out = QuantLinear(inner, dim, dtype)
        else:
            self.to_q = nn.Linear(dim, inner, bias=False)
            self.to_kv = nn.Linear(dim, inner * 2, bias=False)
            self.to_out = nn.Linear(inner, dim, bias=False)
        self.quant = quant
        self.heads, self.dim_head = heads, dim_head
        self.dtype = dtype
        self.impl = impl
        self.model_group = model_group if m > 1 else None
        self.seq_shard = bool(seq_shard) and self.model_group is not None

    def reduce_out(self, out: torch.Tensor) -> torch.Tensor:
        """The sum over ``model`` of the row-parallel output's partials,
        in fp32 (this rank's sequence shard of it under ``seq_shard``)."""
        if self.seq_shard:
            return coll.reduce_scatter_seq(out.float(), self.model_group)
        return coll.reduce_from_model(out.float(), self.model_group)

    def _linear(self, x: torch.Tensor, lin: nn.Module) -> torch.Tensor:
        if self.quant == "int8":
            return lin(x)
        return F.linear(x, lin.weight.to(self.dtype))
    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        attn_mask=None,
        key_padding_mask: Optional[torch.Tensor] = None,
        return_attn: bool = False,
    ):
        """``return_attn=True`` also returns the fp32 post-softmax
        probabilities ``[B, H, Tq, Tk]``, through the dense path whatever
        ``impl`` is (the flash kernels never materialise them)."""
        if self.model_group is not None:
            x = (coll.gather_seq(x, self.model_group) if self.seq_shard
                 else coll.copy_to_model(x, self.model_group))
        kv_x = x if context is None else context
        x = x.to(self.dtype)
        kv_x = kv_x.to(self.dtype)
        q = self._linear(x, self.to_q)
        k, v = self._linear(kv_x, self.to_kv).chunk(2, dim=-1)

        def split_heads(t: torch.Tensor) -> torch.Tensor:
            b, n, _ = t.shape
            return (
                t.view(b, n, self.heads, self.dim_head)
                .transpose(1, 2)
                .contiguous()
            )

        if return_attn:
            if isinstance(attn_mask, np.ndarray):
                attn_mask = torch.from_numpy(attn_mask).to(q.device)
            out, attn = dense_masked_attention(
                split_heads(q), split_heads(k), split_heads(v),
                scale=self.dim_head**-0.5, attn_mask=attn_mask,
                key_padding_mask=key_padding_mask, return_attn=True,
            )
        else:
            out = masked_attention(
                split_heads(q),
                split_heads(k),
                split_heads(v),
                scale=self.dim_head**-0.5,
                attn_mask=attn_mask,
                key_padding_mask=key_padding_mask,
                impl=self.impl,
            )
        b, h, n, d = out.shape
        out = out.transpose(1, 2).reshape(b, n, h * d)
        out = self._linear(out, self.to_out)
        out = out if self.model_group is None else self.reduce_out(out)
        return (out, attn) if return_attn else out


class MCALayer(nn.Module):
    """Transformer block with one shared LayerNorm."""

    def __init__(
        self,
        dim: int,
        dim_head: int,
        heads: int,
        ff_mult: float,
        dtype: torch.dtype = torch.float32,
        attn_impl: str = "dense",
        quant: str = "none",
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
        fused_ff: bool = True,
        model_group=None,
        seq_shard: bool = False,
    ):
        super().__init__()
        self.moe = int(moe_experts) > 0
        if self.moe and quant != "none":
            raise ValueError(
                "int8 quantization covers the dense projections only; "
                "moe_experts requires quant='none'"
            )
        self.attn = Attention(
            dim, dim_head=dim_head, heads=heads, dtype=dtype,
            impl=attn_impl, quant=quant, model_group=model_group, seq_shard=seq_shard,
        )
        if self.moe:
            self.ff = MoEFeedForward(
                dim, int(moe_experts), mult=ff_mult,
                capacity_factor=moe_capacity_factor, dtype=dtype,
                model_group=model_group, seq_shard=seq_shard,
            )
        else:
            self.ff = FeedForward(
                dim, mult=ff_mult, dtype=dtype, quant=quant, fused=fused_ff
            )
        self.norm = LayerNorm(dim)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask=None,
        padding_mask: Optional[torch.Tensor] = None,
        return_attn: bool = False,
    ):
        """``return_attn=True``: ``(x, the attention's probabilities)``."""
        x = self.norm(x)
        out = self.attn(
            x, attn_mask=attn_mask, key_padding_mask=padding_mask,
            return_attn=return_attn,
        )
        if return_attn:
            out, attn = out
        x = out.to(x.dtype) + x
        x = self.norm(x)
        # the router sees the padding, so experts spend their capacity
        # on real tokens
        ff_out = self.ff(x, padding_mask) if self.moe else self.ff(x)
        x = ff_out.to(x.dtype) + x
        return (x, attn) if return_attn else x


class DecoderBlock(nn.Module):
    """A DeepSeek-V3 decoder block as the fusion stack's block (the
    ``deepseek_v3`` block of :class:`~mca_tpu_torch.models.mca.MCA`):
    two RMSNorms (``attn_norm``, ``ff_norm``) and residuals around the
    sublayers on the fp32 stream, ``x = x + attn(attn_norm(x)); x = x +
    ff(ff_norm(x))``, where :class:`MCALayer` shares one LayerNorm and
    adds the normed activations.  ``attn`` is latent attention
    (:class:`~mca_tpu_torch.models.mla.MLAttention`); ``ff`` a SwiGLU of
    ``dense_inner`` (``moe=None``) or the routed and shared experts
    (:class:`~mca_tpu_torch.models.routed_moe.RoutedMoE` built from the
    ``moe`` keyword arguments), which see the padding."""

    def __init__(self, dim: int, attn: nn.Module, dense_inner: int, moe: Optional[dict],
                 eps: float, dtype: torch.dtype = torch.float32):
        super().__init__()
        from mca_tpu_torch.models.mla import RMSNorm
        from mca_tpu_torch.models.routed_moe import RoutedMoE, SwiGLU

        self.attn_norm = RMSNorm(dim, eps)
        self.attn = attn
        self.ff_norm = RMSNorm(dim, eps)
        self.moe = moe is not None
        self.ff = RoutedMoE(dim, dtype=dtype, **moe) if self.moe else SwiGLU(dim, dense_inner, dtype)

    def forward(self, x: torch.Tensor, attn_mask=None,
                padding_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.float()
        x = x + self.attn(self.attn_norm(x), attn_mask, padding_mask).float()
        h = self.ff_norm(x)
        return x + (self.ff(h, padding_mask) if self.moe else self.ff(h)).float()
