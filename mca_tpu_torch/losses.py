"""The part of the contrastive loss graph the embedding forward needs.

Ported from ``mca_tpu/losses.py``: :func:`combo_key` and the output-dict
slicing of ``MCAPretrainingLoss.__call__`` (pooled return tokens ->
named embeddings), plus the shared ``logit_scale`` parameter so the
state dict matches the torch reference (``loss.loss_fn.logit_scale``).
The pair losses themselves (``clip_contrastive_loss`` and the FCL
graph) come with the training slice; ``no_loss=False`` raises.
"""

from __future__ import annotations

import math
from typing import Dict, FrozenSet, Sequence, Tuple

import torch
from torch import nn

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)


def combo_key(combo: FrozenSet[int]) -> str:
    """Stable string key for a modality combo."""
    return "combo:" + ",".join(str(i) for i in sorted(combo))


class _LossFn(nn.Module):
    """Holds the shared learnable temperature."""

    def __init__(self):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))


class MCAPretrainingLoss(nn.Module):
    """Slices the pooled return tokens ``[B, R, D]`` into the named
    embeddings: one per modality, one per fusion combo under FCL, and
    ``fusion`` (the FCL root combo, or the single fusion token)."""

    def __init__(
        self,
        modality_names: Sequence[str],
        do_fcl: bool = False,
        fusion_combos: Tuple[FrozenSet[int], ...] = (),
        no_fusion: bool = False,
    ):
        super().__init__()
        self.modality_names = tuple(modality_names)
        self.do_fcl = do_fcl
        self.fusion_combos = tuple(fusion_combos)
        self.no_fusion = no_fusion
        self.loss_fn = _LossFn()

    def output_keys(self) -> Tuple[str, ...]:
        """The embedding keys :meth:`forward` returns, sorted."""
        keys = set(self.modality_names)
        if self.do_fcl:
            keys.update(combo_key(c) for c in self.fusion_combos)
        if not self.no_fusion:
            keys.add("fusion")
        return tuple(sorted(keys))

    def forward(
        self,
        pooled_tokens: torch.Tensor,
        sample_mask: Dict[str, torch.Tensor],
        no_loss: bool = False,
    ) -> Dict[str, torch.Tensor]:
        if not no_loss:
            raise NotImplementedError(
                "the contrastive loss graph comes with the training "
                "slice; call with no_loss=True"
            )
        names = list(self.modality_names)
        outputs = {m: pooled_tokens[:, i, :] for i, m in enumerate(names)}
        mlen = len(names)
        if self.do_fcl:
            for i, combo in enumerate(self.fusion_combos):
                assert i + mlen < pooled_tokens.shape[1]
                outputs[combo_key(combo)] = pooled_tokens[:, i + mlen, :]
            if not self.no_fusion:
                outputs["fusion"] = outputs[combo_key(self.fusion_combos[0])]
        elif not self.no_fusion:
            outputs["fusion"] = pooled_tokens[:, mlen, :]
        return outputs
