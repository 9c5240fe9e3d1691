"""The Everything-At-Once baseline, ported from ``mca_tpu/models/eao.py``.

No fusion tokens and no static mask: the shared ``depth`` blocks run
once per channel, each modality alone and then each modality combo of
``adjusted_powerset(modalities, fusion_combos)`` (the modalities'
tokens concatenated), each pass followed by the fp32 final norm and a
masked mean over its valid tokens; the pooled vectors, one per channel,
feed the same :class:`mca_tpu_torch.losses.MCAPretrainingLoss`.

Attention is unmasked apart from the per-sample key padding, so on the
card every pass goes through the flash forward (K1) with an all-live
mask of the pass's length (``ops/flash_attention.py``), the K1 schedule
of a dense ``[T, T]``.  ``group_channels`` (``eao_group_channels``, off by
default as in the JAX package) runs channels of equal length as one
pass stacked on the batch axis; attention and pooling never mix
samples, so the result is the same.

EAO pools by mean only, as in the JAX package (the reference's
attentive branch referenced a mask it never built).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mca_tpu_torch import masks as masks_lib
from mca_tpu_torch.encoders import build_encoder
from mca_tpu_torch.losses import MCAPretrainingLoss
from mca_tpu_torch.models.layers import LayerNorm, MCALayer
from mca_tpu_torch.models.mca import dtype_of, init_weights
from mca_tpu_torch.models.pool import MeanTokenProjectionPool


class EAO(nn.Module):
    """One unmasked pass of the shared blocks per modality and combo."""

    def __init__(
        self,
        encoder_configs: Dict[str, Any],
        dim: int,
        depth: int,
        dim_head: int = 64,
        heads: int = 8,
        ff_mult: float = 4,
        bimodal_contrastive: bool = False,
        non_fusion_fcl: bool = False,
        fcl: bool = False,
        fusion_combos: Sequence[int] = (4, 5),
        zorro: bool = False,
        no_fusion: bool = True,
        mean_pool: bool = True,
        precision: str = "fp32",
        attention_impl: str = "dense",
        quant: str = "none",
        moe_experts: int = 0,
        moe_capacity_factor: float = 2.0,
        remat: bool = False,
        group_channels: bool = False,
        fused_ff: bool = True,
        data_group=None,
        model_group=None,
    ):
        super().__init__()
        if not mean_pool:
            raise ValueError(
                "EAO supports mean pooling only (the reference's attentive "
                "branch was non-functional)"
            )
        self.modality_types = tuple(encoder_configs.keys())
        self.combos = tuple(
            masks_lib.adjusted_powerset(
                range(len(self.modality_types)), list(fusion_combos)
            )
        )
        self.channels = [(i,) for i in range(len(self.modality_types))] + [
            tuple(sorted(c)) for c in self.combos
        ]
        self.no_fusion = no_fusion
        self.remat = bool(remat)
        self.group_channels = bool(group_channels)
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
                    model_group=model_group,
                )
                for _ in range(depth)
            ]
        )
        self.norm = LayerNorm(dim)
        self.attn_pool = MeanTokenProjectionPool(
            token_types=None, in_dim=dim, out_dim=dim, projection=False
        )
        self.loss = MCAPretrainingLoss(
            self.modality_types,
            do_fcl=fcl and not zorro,
            fusion_combos=self.combos,
            no_fusion=no_fusion,
            bimodal_contrastive=bimodal_contrastive,
            non_fusion_fcl=non_fusion_fcl,
            data_group=data_group,
        )

    def single_pass(self, tokens: torch.Tensor, padding: torch.Tensor) -> torch.Tensor:
        """``depth`` blocks with no static mask, the final norm and the
        mean pool: ``[B, T, D] -> [B, 1, D]``."""
        x = tokens.to(self.dtype)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(layer, x, None, padding, use_reentrant=False)
            else:
                x = layer(x, None, padding)
        return self.attn_pool(self.norm(x.float()), padding)

    def forward(
        self,
        batch: Dict[str, Dict[str, torch.Tensor]],
        no_loss: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Any]:
        tokens, pads, sample_mask = [], [], {}
        for m in self.modality_types:
            t, a = self.encoders[m](batch[m], generator)
            tokens.append(t)
            pads.append(a.bool())
            sample_mask[m] = (a == 0).sum(dim=1) != 0

        def channel_inputs(channel):
            return (
                torch.cat([tokens[i] for i in channel], dim=1),
                torch.cat([pads[i] for i in channel], dim=1),
            )

        if not self.group_channels:
            per_channel = [self.single_pass(*channel_inputs(c)) for c in self.channels]
        else:
            by_len = defaultdict(list)
            for ci, channel in enumerate(self.channels):
                by_len[sum(tokens[i].shape[1] for i in channel)].append(ci)
            bsz = tokens[0].shape[0]
            per_channel: list = [None] * len(self.channels)
            for tlen in sorted(by_len):
                idxs = by_len[tlen]
                toks, pad = zip(*(channel_inputs(self.channels[ci]) for ci in idxs))
                pooled = self.single_pass(torch.cat(toks), torch.cat(pad))
                for j, ci in enumerate(idxs):
                    per_channel[ci] = pooled[j * bsz : (j + 1) * bsz]
        pooled, sample_mask = self.loss.gather(torch.cat(per_channel, dim=1), sample_mask)
        outputs = self.loss(pooled, sample_mask, no_loss=no_loss)
        outputs["modality_sample_mask"] = sample_mask
        return outputs

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Random weights from ``generator`` (:func:`init_weights`)."""
        return init_weights(self, generator)
