"""Fusion-transformer primitives, ported from ``mca_tpu/models/layers.py``.

- :class:`LayerNorm` — bias-less (learnable ``gamma``), fp32, eps 1e-6.
- :class:`FeedForward` — GEGLU MLP, ``inner = int(dim * mult * 2/3)``,
  bias-free, exact (erf) GELU.  ``fused=True`` (the forward-only entry
  points, as the JAX package's ``MCA_FUSED_FF`` on serve / infer) goes
  through the fused op (:func:`mca_tpu_torch.ops.fused_ff.geglu_ff`:
  the Hopper kernel on CUDA, its plain version on the CPU) and refuses
  to run where autograd would need its weights' gradients;
  ``fused=False`` (training) is the differentiable linear -> gelu ->
  linear chain.
- :class:`Attention` — MHA with a fused ``to_kv`` projection (k the
  first half), cross-attention through ``context`` (the attentive
  pool), and the static / dynamic mask pair.
- :class:`MCALayer` — one shared norm, residuals around the *normed*
  activations: ``x = norm(x); x = attn(x) + x; x = norm(x);
  x = ff(x) + x``.

dtype chain (as in the JAX package): the norm returns fp32; attention
and FF cast their input to the compute dtype; their outputs are cast
back to the residual's dtype.  Parameters stay fp32 and are cast at use.
Parameter names are the torch reference's (``to_q.weight``,
``feedforward.0.weight``, ``norm.gamma``, ...).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mca_tpu_torch.encoders import LN_EPS
from mca_tpu_torch.ops.attention import masked_attention
from mca_tpu_torch.ops.fused_ff import geglu_ff, prepare_geglu_weights


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
    """GEGLU feed-forward, fused (forward only) or unfused.

    ``feedforward.0`` is W1 ``[2*inner, dim]`` (u half first),
    ``feedforward.2`` is W2 ``[dim, inner]``; index 1 stands for the
    reference's parameter-free GEGLU.  On the fused path the transposed,
    interleaved, padded compute-dtype copies the op takes are made
    once per weight version and device, not on every call; they are
    detached, so that path raises when grad mode is on and a weight
    requires grad, instead of leaving the weights without gradients.
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
        if quant != "none":
            raise NotImplementedError(
                f"quant={quant!r}: int8 serving comes with the quant slice"
            )
        inner = int(dim * mult * 2 / 3)
        self.feedforward = nn.ModuleList(
            [
                nn.Linear(dim, inner * 2, bias=False),
                nn.Identity(),
                nn.Linear(inner, dim, bias=False),
            ]
        )
        self.dtype = dtype
        self.fused = fused
        self._prepared = None
        self._prepared_key = None

    def _weights(self):
        w1 = self.feedforward[0].weight
        w2 = self.feedforward[2].weight
        key = (w1.data_ptr(), w1._version, w2.data_ptr(), w2._version)
        if key != self._prepared_key:
            with torch.no_grad():
                self._prepared = prepare_geglu_weights(
                    w1.t(), w2.t(), self.dtype
                )
            self._prepared_key = key
        return self._prepared

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w1 = self.feedforward[0].weight
        w2 = self.feedforward[2].weight
        x = x.to(self.dtype)
        if self.fused:
            if torch.is_grad_enabled() and (w1.requires_grad or w2.requires_grad):
                raise RuntimeError(
                    "the fused GEGLU feed-forward is forward-only: build "
                    "the model with fused_ff=False to train, or run under "
                    "torch.no_grad() / inference_mode()"
                )
            return geglu_ff(x.contiguous(), *self._weights())
        h, gate = F.linear(x, w1.to(self.dtype)).chunk(2, dim=-1)
        return F.linear(
            F.gelu(gate, approximate="none") * h, w2.to(self.dtype)
        )


class Attention(nn.Module):
    """Multi-head attention; ``attn_mask`` static ``[Tq, Tk]`` (True =
    blocked), ``key_padding_mask`` ``[B, Tk]`` (True = padded)."""

    def __init__(
        self,
        dim: int,
        dim_head: int = 64,
        heads: int = 8,
        dtype: torch.dtype = torch.float32,
        impl: str = "dense",
        quant: str = "none",
    ):
        super().__init__()
        if quant != "none":
            raise NotImplementedError(
                f"quant={quant!r}: int8 serving comes with the quant slice"
            )
        inner = dim_head * heads
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)
        self.heads, self.dim_head = heads, dim_head
        self.dtype = dtype
        self.impl = impl

    def _linear(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        return F.linear(x, lin.weight.to(self.dtype))

    def forward(
        self,
        x: torch.Tensor,
        context: Optional[torch.Tensor] = None,
        attn_mask=None,
        key_padding_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
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
        return self._linear(out, self.to_out)


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
        fused_ff: bool = True,
    ):
        super().__init__()
        if int(moe_experts) > 0:
            raise NotImplementedError(
                "moe_experts > 0: the MoE feed-forward is not ported yet"
            )
        self.attn = Attention(
            dim, dim_head=dim_head, heads=heads, dtype=dtype,
            impl=attn_impl, quant=quant,
        )
        self.ff = FeedForward(
            dim, mult=ff_mult, dtype=dtype, quant=quant, fused=fused_ff
        )
        self.norm = LayerNorm(dim)

    def forward(
        self,
        x: torch.Tensor,
        attn_mask=None,
        padding_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x = self.norm(x)
        x = self.attn(
            x, attn_mask=attn_mask, key_padding_mask=padding_mask
        ).to(x.dtype) + x
        x = self.norm(x)
        return self.ff(x).to(x.dtype) + x
