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

Not ported yet (they raise): pipeline / sequence parallelism, int8
quantization.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mca_tpu_torch import masks as masks_lib
from mca_tpu_torch.encoders import build_encoder
from mca_tpu_torch.losses import LOGIT_SCALE_INIT, MCAPretrainingLoss
from mca_tpu_torch.models.layers import Attention, LayerNorm, MCALayer
from mca_tpu_torch.models.pool import MeanTokenProjectionPool


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
        seq_shard: bool = False,
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
        remat: bool = False,
        fused_ff: bool = True,
    ):
        super().__init__()
        if mean_pool and fcl and not zorro:
            # as the JAX package asserts: one mean over all fusion tokens
            # leaves no per-combo pooled token
            raise ValueError(
                "mean_pool is incompatible with fusion-channel pooling "
                "(fcl); use zorro or attentive pooling"
            )
        if int(pipeline_stages or 0) > 1 or seq_shard:
            raise NotImplementedError(
                "pipeline / sequence parallelism come with the "
                "parallelism slice"
            )
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
        self.layers = nn.ModuleList(
            [
                MCALayer(
                    dim, dim_head, heads, ff_mult, dtype=self.dtype,
                    attn_impl=attention_impl, quant=quant,
                    moe_experts=moe_experts,
                    moe_capacity_factor=moe_capacity_factor, fused_ff=fused_ff,
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
        )

    def forward(
        self,
        batch: Dict[str, Dict[str, torch.Tensor]],
        no_loss: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
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
        padding = torch.cat(pad_masks, dim=1)

        attn_mask = self.mask_set.attn_mask
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, attn_mask, padding, use_reentrant=False)
            else:
                x = layer(x, attn_mask, padding)
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
        outputs = self.loss(pooled, sample_mask, no_loss=no_loss)
        outputs["modality_sample_mask"] = sample_mask
        return outputs

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (:func:`init_weights`)."""
        return init_weights(self, generator)


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
            elif name.endswith("logit_scale"):
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
                else:
                    bound = p.shape[1] ** -0.5  # [out, in]: fan-in
                p.copy_(
                    torch.empty(p.shape).uniform_(
                        -bound, bound, generator=generator
                    )
                )
    return model
