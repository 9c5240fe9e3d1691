"""The MCA fusion transformer, ported from ``mca_tpu/models/mca.py``.

One packed forward: per-modality encoders -> learnable fusion tokens
appended -> ``depth`` masked transformer blocks under the static
zorro/MCA mask and the dynamic per-sample padding mask -> fp32 final
norm -> attentive pooling into the return tokens (with ``mean_pool``,
a masked mean per token type) -> the named embeddings and, unless
``no_loss``, the contrastive loss graph
(:class:`mca_tpu_torch.losses.MCAPretrainingLoss`).  ``zorro``,
``fcl`` and ``no_fusion`` change the masks, the return-token layout and
the pair list.

``fused_ff`` picks the feed-forward: the fused forward-only kernel
(default; the serving path) or the differentiable unfused chain that
training builds with (the JAX package's ``MCA_FUSED_FF`` split).

Masks are numpy constants built once (``mca_tpu_torch.masks``); the
self-attention mask stays numpy because the flash kernel derives its
tile schedule from it, the pooling mask is a non-persistent buffer so
it moves with the module.  Parameters stay fp32; ``precision='bf16'``
runs the transformer blocks in bf16 with fp32 norms and softmax
statistics.

``generator`` (train mode only) feeds the encoders' dropout
(:mod:`mca_tpu_torch.encoders`); eval and inference never draw.

``remat`` wraps each block in ``torch.utils.checkpoint`` while
gradients are on, as the JAX package wraps it in ``nn.remat``: the
backward recomputes the block's forward (the flash forward included)
instead of keeping its activations.

``moe_experts > 0`` puts the expert-choice mixture of experts
(:mod:`mca_tpu_torch.models.moe`) in every block's feed-forward.

``block`` (``model_type: deepseek_v3``, :func:`mca_tpu_torch.config.block_config`)
replaces the MCA block by DeepSeek-V3's decoder block
(:class:`~mca_tpu_torch.models.layers.DecoderBlock`): latent attention
through the flash kernels at head dims (192, 128), a dense SwiGLU in the
first ``first_k_dense_replace`` layers and the routed experts this
process holds (the first of ``ep_size`` shares) with the shared experts
in the rest, and a final RMSNorm.  The encoders, fusion tokens, masks,
pool and loss are the MCA ones.  In training the forward also returns
``balance_loss``, the routed layers' balance losses summed, which the
training step adds to the loss.  It runs on one process (no mesh of
several ranks), without ``remat``, int8 or ``return_attn``.

``quant="int8"`` runs the blocks' five projections on int8 weights
(:mod:`mca_tpu_torch.ops.quant`, serving only); the attentive pool
stays float.

``data_group`` / ``model_group`` / ``pipe_group`` (the training run's
mesh, :mod:`mca_tpu_torch.parallel`): over ``data`` the pooled tokens and
the modality masks are gathered before the loss, so that every rank
computes the loss of the global batch (:meth:`MCAPretrainingLoss.gather`);
over ``model`` the blocks' attention is tensor-parallel by heads (and a
MoE block's experts are split over it), and with ``seq_shard`` the
residual stream between blocks is this rank's ``T / model`` tokens; over
``pipe`` (``pipeline_stages > 1``) the block stack runs as a GPipe
pipeline of ``pipeline_microbatches`` (:mod:`mca_tpu_torch.parallel.pipeline`),
its input widened to the blocks' fp32 output dtype (the shared norm
returns fp32, so the sequential stack's later blocks see fp32 too), with
``remat`` per block inside a stage; the pool and the loss then run on
every stage.  ``seq_shard`` and a pipeline together raise, as in the JAX
package.  Without groups (``infer``, ``serve``, export, one process)
``seq_shard`` and ``pipeline_stages`` are ignored, as in the JAX package,
whose consumers without a mesh run the sequential stack.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mca_tpu_torch import masks as masks_lib
from mca_tpu_torch.encoders import build_encoder
from mca_tpu_torch.losses import LOGIT_SCALE_INIT, MCAPretrainingLoss
from mca_tpu_torch.models.layers import Attention, DecoderBlock, LayerNorm, MCALayer
from mca_tpu_torch.models.mla import MLAttention, RMSNorm
from mca_tpu_torch.models.pool import MeanTokenProjectionPool
from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel.pipeline import pipeline_layers


def dtype_of(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


class MCA(nn.Module):
    """Multimodal-contrastive-alignment fusion transformer."""

    def __init__(
        self,
        encoder_configs: Dict[str, Any],
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: float = 4,
        num_fusion_tokens: int = 16,
        bimodal_contrastive: bool = False,
        non_fusion_fcl: bool = False,
        fcl: bool = False,
        fusion_combos: Sequence[int] = (4, 5),
        zorro: bool = False,
        no_fusion: bool = False,
        mean_pool: bool = False,
        precision: str = "fp32",
        attention_impl: str = "dense",
        quant: str = "none",
        pipeline_stages: int = 0,
        pipeline_microbatches: int = 0,
        seq_shard: bool = False,
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
        remat: bool = False,
        fused_ff: bool = True,
        block: Optional[Dict[str, Any]] = None,
        data_group=None,
        model_group=None,
        pipe_group=None,
    ):
        super().__init__()
        if block is not None:
            # what config.block_config cannot see: the mesh and the
            # service's quantisation
            several = [n for n, g in (("data", data_group), ("model", model_group),
                                      ("pipe", pipe_group)) if coll.group_size(g) > 1]
            if several or quant != "none":
                raise ValueError(
                    "the deepseek_v3 block runs on one process without int8 (mesh axes "
                    f"over one rank: {several}, quant={quant!r})")
        if mean_pool and fcl and not zorro:
            # as the JAX package asserts: one mean over all fusion tokens
            # leaves no per-combo pooled token
            raise ValueError(
                "mean_pool is incompatible with fusion-channel pooling "
                "(fcl); use zorro or attentive pooling"
            )
        self.pipeline_stages = int(pipeline_stages or 0)
        self.pipeline_microbatches = int(pipeline_microbatches or 0)
        # the stack pipelines only on a mesh with a pipe axis
        self.pipe_group = (pipe_group if self.pipeline_stages > 1
                           and coll.group_size(pipe_group) > 1 else None)
        if self.pipe_group is not None and seq_shard:
            raise ValueError("seq_shard and pipeline_stages (mesh_pipe > 1) are "
                             "mutually exclusive")
        # the residual stream is sharded over model only where the
        # attention is (a mesh of one model rank runs the plain stack)
        self.seq_group = model_group if seq_shard and coll.group_size(model_group) > 1 else None
        self.modality_types = tuple(encoder_configs.keys())
        token_dims = [
            int(encoder_configs[m]["max_tokens"]) for m in self.modality_types
        ]
        self.mask_set = masks_lib.build_masks(
            token_dims,
            num_fusion_tokens,
            list(fusion_combos),
            zorro=zorro,
            fcl=fcl,
            no_fusion=no_fusion,
        )
        self.no_fusion = no_fusion
        self.remat = bool(remat)
        self.dtype = dtype_of(precision)
        self.encoders = nn.ModuleDict(
            {
                name: build_encoder(name, cfg, dim)
                for name, cfg in encoder_configs.items()
            }
        )
        if block is not None:
            self.layers = nn.ModuleList(
                [decoder_block(dim, heads, block, i, self.mask_set.seq_len, self.dtype,
                               attention_impl) for i in range(depth)])
            self.norm = RMSNorm(dim, float(block["rms_norm_eps"]))
            # the routed layers, whose balance losses the forward returns
            self._routed = tuple(layer.ff for layer in self.layers if layer.moe)
        else:
            self._routed = ()
            self.layers = nn.ModuleList(
                [
                    MCALayer(
                        dim, dim_head, heads, ff_mult, dtype=self.dtype,
                        attn_impl=attention_impl, quant=quant,
                        moe_experts=moe_experts,
                        moe_capacity_factor=moe_capacity_factor, fused_ff=fused_ff,
                        model_group=model_group, seq_shard=self.seq_group is not None,
                    )
                    for _ in range(depth)
                ]
            )
            self.norm = LayerNorm(dim)
        if not no_fusion:
            self.fusion_tokens = nn.Parameter(
                torch.zeros(self.mask_set.num_fusion_tokens, dim)
            )
        self.mean_pool = bool(mean_pool)
        if self.mean_pool:
            self.attn_pool = MeanTokenProjectionPool(
                token_types=[int(t) for t in self.mask_set.token_types],
                in_dim=dim, out_dim=dim, projection=False,
            )
        else:
            self.return_tokens = nn.Parameter(
                torch.zeros(self.mask_set.num_return_tokens, dim)
            )
            self.attn_pool = Attention(
                dim, dim_head=dim_head, heads=heads, dtype=torch.float32,
                impl="dense",
            )
            self.register_buffer(
                "pool_mask",
                torch.from_numpy(self.mask_set.pool_mask.copy()),
                persistent=False,
            )
        self.loss = MCAPretrainingLoss(
            self.modality_types,
            do_fcl=fcl and not zorro,
            fusion_combos=self.mask_set.fusion_combos,
            no_fusion=no_fusion,
            bimodal_contrastive=bimodal_contrastive,
            non_fusion_fcl=non_fusion_fcl,
            data_group=data_group,
        )

    def pack_sequence(self, batch: Dict[str, Dict[str, torch.Tensor]],
                      generator: Optional[torch.Generator] = None):
        """Encode and pack into one ``[B, T, D]`` sequence in the compute
        dtype, the fusion tokens appended (never padded); returns ``(x,
        padding, sample_mask)``.  Shared by :meth:`forward` and
        :meth:`attention_maps`, so that the maps see the forward's input."""
        tokens, pad_masks, sample_mask = [], [], {}
        for m in self.modality_types:
            t, a = self.encoders[m](batch[m], generator)
            tokens.append(t)
            pad_masks.append(a.bool())
            sample_mask[m] = (a == 0).sum(dim=1) != 0
        bsz = tokens[0].shape[0]
        if not self.no_fusion:
            tokens.append(
                self.fusion_tokens[None]
                .expand(bsz, -1, -1)
                .to(tokens[0].dtype)
            )
            pad_masks.append(
                torch.zeros(
                    (bsz, self.mask_set.num_fusion_tokens),
                    dtype=torch.bool,
                    device=pad_masks[0].device,
                )
            )
        x = torch.cat(tokens, dim=1).to(self.dtype)
        return x, torch.cat(pad_masks, dim=1), sample_mask

    def forward(
        self,
        batch: Dict[str, Dict[str, torch.Tensor]],
        no_loss: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        x, padding, sample_mask = self.pack_sequence(batch, generator)
        bsz = x.shape[0]
        attn_mask = self.mask_set.attn_mask
        if self.pipe_group is not None:
            x = pipeline_layers(self.layers, x.float(), padding, attn_mask, self.pipe_group,
                                self.pipeline_stages, self.pipeline_microbatches,
                                remat=self.remat)
        else:
            if self.seq_group is not None:
                x = coll.split_seq(x, self.seq_group)
            for layer in self.layers:
                if self.remat and torch.is_grad_enabled():
                    x = checkpoint(layer, x, attn_mask, padding, use_reentrant=False)
                else:
                    x = layer(x, attn_mask, padding)
            if self.seq_group is not None:
                x = coll.gather_seq_out(x, self.seq_group)
        x = self.norm(x.float())

        if self.mean_pool:
            pooled = self.attn_pool(x, padding)
        else:
            ret = self.return_tokens[None].expand(bsz, -1, -1)
            pooled = (
                self.attn_pool(
                    ret,
                    context=x,
                    attn_mask=self.pool_mask,
                    key_padding_mask=padding,
                )
                + ret
            )
        pooled, sample_mask = self.loss.gather(pooled, sample_mask)
        outputs = self.loss(pooled, sample_mask, no_loss=no_loss)
        outputs["modality_sample_mask"] = sample_mask
        balance = [b for b in (m.take_balance_loss() for m in self._routed) if b is not None]
        if balance:
            outputs["balance_loss"] = torch.stack(balance).sum()
        return outputs

    def attention_maps(self, batch: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
        """The post-softmax attention probabilities (fp32), as the JAX
        package's ``MCA.attention_maps``: ``{"layers": [depth, B, H, T,
        T]}`` and, with the attentive pool, ``"pool": [B, H, R, T]``.
        Every block takes the dense path here (the flash kernels never
        materialise probabilities); the sequential stack, without groups."""
        if not isinstance(self.layers[0], MCALayer):
            raise NotImplementedError("attention_maps covers the MCA block only")
        x, padding, _ = self.pack_sequence(batch)
        bsz = x.shape[0]
        attn_mask = self.mask_set.attn_mask
        maps = []
        for layer in self.layers:
            x, attn = layer(x, attn_mask, padding, return_attn=True)
            maps.append(attn)
        out = {"layers": torch.stack(maps)}
        if not self.mean_pool:
            x = self.norm(x.float())
            ret = self.return_tokens[None].expand(bsz, -1, -1)
            _, out["pool"] = self.attn_pool(ret, context=x, attn_mask=self.pool_mask,
                                            key_padding_mask=padding, return_attn=True)
        return out

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (:func:`init_weights`)."""
        return init_weights(self, generator)


def decoder_block(dim: int, heads: int, block: Dict[str, Any], index: int, seq_len: int,
                  dtype: torch.dtype, attention_impl: str) -> DecoderBlock:
    """Layer ``index`` of the ``deepseek_v3`` stack: latent attention, then
    a dense SwiGLU below ``first_k_dense_replace``, else the first of the
    routed experts' ``ep_size`` shares (an expert-parallel rank's, the
    only rank here) and the shared experts."""
    eps = float(block["rms_norm_eps"])
    attn = MLAttention(
        dim, heads, int(block["kv_lora_rank"]), int(block["qk_nope_head_dim"]),
        int(block["qk_rope_head_dim"]), int(block["v_head_dim"]), float(block["rope_theta"]),
        seq_len, eps, dtype, "pallas" if attention_impl == "auto" else attention_impl)
    moe = None
    if index >= int(block["first_k_dense_replace"]):
        experts, ep = int(block["n_routed_experts"]), int(block["ep_size"])
        if experts % ep:
            raise ValueError(f"ep_size={ep} does not divide n_routed_experts={experts}")
        moe = dict(experts=experts, top_k=int(block["num_experts_per_tok"]),
                   inner=int(block["moe_intermediate_size"]),
                   n_shared=int(block["n_shared_experts"]), held=(0, experts // ep),
                   scaling=float(block["routed_scaling_factor"]),
                   norm_topk_prob=bool(block["norm_topk_prob"]),
                   aux_loss_alpha=float(block["aux_loss_alpha"]),
                   bias_update_speed=float(block["bias_update_speed"]))
    return DecoderBlock(dim, attn, int(block["intermediate_size"]), moe, eps, dtype)


def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None):
    """Random weights from ``generator``, with the JAX package's
    initialisers: normal(1) token tables, position embeddings and fusion
    / return tokens, torch ``nn.Linear`` uniform(+-1/sqrt(fan_in)) for
    every linear weight, zeros for biases, ones for norm scales,
    log(1/0.07) for the logit scale.  The MoE leaves keep the JAX
    layout: the router ``[dim, E]`` has its fan-in first, the stacked
    experts ``[E, in, out]`` the matrix's own input width."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma") or (name.endswith("weight") and p.ndim == 1):
                p.fill_(1.0)  # the norms' scales
            elif name.split(".")[-1].startswith("logit_scale"):
                p.fill_(LOGIT_SCALE_INIT)
            elif name.endswith("bias"):
                p.zero_()
            elif name.endswith("tokens") or "embedding" in name:
                p.copy_(torch.randn(p.shape, generator=generator))
            else:
                if name.endswith("router.weight"):
                    bound = p.shape[0] ** -0.5  # [in, E]
                elif name.split(".")[-2] == "experts":
                    bound = p.shape[-2] ** -0.5  # [E, in, out]
                elif p.ndim == 3:
                    bound = p.shape[-1] ** -0.5  # routed experts [held, out, in]
                else:
                    bound = p.shape[1] ** -0.5  # [out, in]: fan-in
                p.copy_(
                    torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator
                    )
                )
    return model
