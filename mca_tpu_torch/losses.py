"""The contrastive pretraining loss graph, ported from ``mca_tpu/losses.py``.

- :func:`clip_contrastive_loss` — CLIP-style symmetric cross-entropy
  with a learnable clamped temperature: logits are raw dot products (no
  L2 normalisation, as in the reference) scaled by
  ``exp(clip(logit_scale))``; an optional per-sample bool mask selects
  which *rows* contribute (columns, the negatives, always span the
  batch); an empty mask gives NaN, which the aggregation masks out.
- :class:`MCAPretrainingLoss` — slices the pooled return tokens into the
  named embeddings, then (unless ``no_loss``) computes every configured
  pair loss under its presence mask, the fusion-channel (FCL) losses
  against the root combo with OR-of-members masks, and the NaN-safe
  aggregates ``fcl_loss``, ``no-fcl_loss`` and ``loss``.  One shared
  temperature (``loss.loss_fn.logit_scale`` in the state dict), or with
  ``separate_modal_loss_fns`` one per pair and per FCL combo, as in the
  JAX package (``loss.logit_scale_{name}``, ``name`` the pair's log name
  or ``fcl|{combo}``, the JAX tree's ``loss/logit_scale_{name}``).

Over a ``data_group`` of several ranks (:meth:`MCAPretrainingLoss.gather`)
the pooled tokens and the modality masks are all-gathered before the
loss, with ``GLOBAL`` backprop by default (``backprop``,
:class:`mca_tpu_torch.parallel.collectives.BackpropType`): every rank then
computes the loss of the global batch, whose masked row means divide by
the global count of live rows; that is the JAX package's semantics (the
loss written on the global batch), not the reference's per-rank labels.
Per-pair temperatures (``separate_modal_loss_fns``) are not ported yet
and raise.
"""

from __future__ import annotations

import math
from itertools import combinations
from typing import Dict, FrozenSet, Optional, Sequence, Tuple

import torch
from torch import nn

from mca_tpu_torch.parallel.collectives import BackpropType, gather_masks, gather_tensor

LOGIT_SCALE_INIT = math.log(1.0 / 0.07)
LOGIT_SCALE_MIN = math.log(1.0)
LOGIT_SCALE_MAX = math.log(100.0)


def combo_key(combo: FrozenSet[int]) -> str:
    """Stable string key for a modality combo."""
    return "combo:" + ",".join(str(i) for i in sorted(combo))


def combo_log_name(combo: FrozenSet[int], modality_names: Sequence[str]) -> str:
    return "_".join(sorted(modality_names[i] for i in combo))


def _masked_row_ce(
    logits: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Mean cross-entropy of row i against column i over the (optionally
    masked) rows; NaN if no row is selected."""
    logp = torch.log_softmax(logits, dim=-1)
    row_loss = -torch.diagonal(logp)
    m = torch.ones_like(row_loss) if mask is None else mask.to(row_loss.dtype)
    s = (row_loss * m).sum()
    cnt = m.sum()
    return torch.where(
        cnt > 0, s / cnt.clamp(min=1.0), torch.full_like(s, float("nan"))
    )


def clip_contrastive_loss(
    emb_a: torch.Tensor,
    emb_b: torch.Tensor,
    logit_scale: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Symmetric CLIP loss of ``[B, D]`` embeddings in fp32."""
    temperature = torch.exp(logit_scale.clamp(LOGIT_SCALE_MIN, LOGIT_SCALE_MAX))
    a32, b32 = emb_a.float(), emb_b.float()
    loss_a = _masked_row_ce((a32 @ b32.T) * temperature, mask)
    loss_b = _masked_row_ce((b32 @ a32.T) * temperature, mask)
    return (loss_a + loss_b) / 2


class _LossFn(nn.Module):
    """Holds the shared learnable temperature."""

    def __init__(self):
        super().__init__()
        self.logit_scale = nn.Parameter(torch.tensor(LOGIT_SCALE_INIT))


class MCAPretrainingLoss(nn.Module):
    """Pairwise contrastive loss graph over the pooled return tokens
    ``[B, R, D]``: named embeddings (one per modality, one per fusion
    combo under FCL, and ``fusion``), then the reference's loss dict."""

    def __init__(
        self,
        modality_names: Sequence[str],
        do_fcl: bool = False,
        fusion_combos: Tuple[FrozenSet[int], ...] = (),
        no_fusion: bool = False,
        bimodal_contrastive: bool = False,
        non_fusion_fcl: bool = False,
        separate_modal_loss_fns: bool = False,
        data_group=None,
    ):
        super().__init__()
        self.modality_names = tuple(modality_names)
        self.do_fcl = do_fcl
        self.fusion_combos = tuple(fusion_combos)
        self.no_fusion = no_fusion
        self.bimodal_contrastive = bimodal_contrastive
        self.non_fusion_fcl = non_fusion_fcl
        self.separate = bool(separate_modal_loss_fns)
        if self.separate:
            # declared in the order the JAX package's loss first uses them
            for name in self.scale_names():
                self.register_parameter(f"logit_scale_{name}",
                                        nn.Parameter(torch.tensor(LOGIT_SCALE_INIT)))
        else:
            self.loss_fn = _LossFn()
        self.data_group = data_group
        self.backprop = BackpropType.GLOBAL

    def gather(self, pooled_tokens: torch.Tensor, sample_mask: Dict[str, torch.Tensor]):
        """The global batch from this rank's rows: ``pooled_tokens`` and
        ``sample_mask`` gathered over ``data_group`` in rank order (the
        tokens with ``backprop``); as they are without a group."""
        if self.data_group is None:
            return pooled_tokens, sample_mask
        return (gather_tensor(pooled_tokens, self.data_group, self.backprop),
                gather_masks(sample_mask, self.data_group))

    def output_keys(self) -> Tuple[str, ...]:
        """The embedding keys :meth:`forward` returns, sorted."""
        keys = set(self.modality_names)
        if self.do_fcl:
            keys.update(combo_key(c) for c in self.fusion_combos)
        if not self.no_fusion:
            keys.add("fusion")
        return tuple(sorted(keys))

    def scale_names(self) -> list:
        """The temperatures' names under ``separate_modal_loss_fns``: each
        pair's log name, then ``fcl|{combo}`` for each FCL combo but the
        root that a loss reads."""
        names = ["_".join(sorted(pair)) for pair in self._pair_list()]
        if self.do_fcl and (not self.no_fusion or self.non_fusion_fcl):
            names += [f"fcl|{combo_log_name(c, self.modality_names)}"
                      for c in self.fusion_combos if c != self.fusion_combos[0]]
        return names

    def scale(self, name: str) -> torch.Tensor:
        """The temperature of pair or combo ``name`` (the shared one
        without ``separate_modal_loss_fns``)."""
        if self.separate:
            return getattr(self, f"logit_scale_{name}")
        return self.loss_fn.logit_scale

    def _pair_list(self) -> list:
        if self.no_fusion:
            return list(combinations(self.modality_names, r=2))
        if self.bimodal_contrastive:
            return list(combinations(list(self.modality_names) + ["fusion"], r=2))
        return [(m, "fusion") for m in self.modality_names]

    def forward(
        self,
        pooled_tokens: torch.Tensor,
        sample_mask: Dict[str, torch.Tensor],
        no_loss: bool = False,
    ) -> Dict[str, torch.Tensor]:
        names = list(self.modality_names)
        outputs = {m: pooled_tokens[:, i, :] for i, m in enumerate(names)}
        mlen = len(names)
        if self.do_fcl:
            for i, combo in enumerate(self.fusion_combos):
                assert i + mlen < pooled_tokens.shape[1]
                outputs[combo_key(combo)] = pooled_tokens[:, i + mlen, :]
            if not self.no_fusion:
                # the FCL root combo is fusion_combos[0]
                outputs["fusion"] = outputs[combo_key(self.fusion_combos[0])]
        elif not self.no_fusion:
            outputs["fusion"] = pooled_tokens[:, mlen, :]
        if no_loss:
            return outputs

        def pair_mask(a: str, b: str) -> torch.Tensor:
            if a == "fusion":
                return sample_mask[b].bool()
            if b == "fusion":
                return sample_mask[a].bool()
            return sample_mask[a].bool() & sample_mask[b].bool()

        scale = self.scale
        losses: Dict[str, torch.Tensor] = {}
        for a, b in self._pair_list():
            name = "_".join(sorted((a, b)))
            losses[name] = clip_contrastive_loss(
                outputs[a], outputs[b], scale(name), mask=pair_mask(a, b)
            )
        if self.do_fcl:
            root = self.fusion_combos[0]
            for combo in self.fusion_combos:
                if combo == root:
                    continue
                cname = combo_log_name(combo, names)
                or_mask = torch.stack(
                    [sample_mask[names[i]].bool() for i in combo]
                ).any(dim=0)
                if not self.no_fusion:
                    losses[f"fcl_fusion|{cname}"] = clip_contrastive_loss(
                        outputs["fusion"], outputs[combo_key(combo)],
                        scale(f"fcl|{cname}"), mask=or_mask,
                    )
                if self.non_fusion_fcl:
                    for mod in names:
                        losses[f"fcl_{mod}|{cname}"] = clip_contrastive_loss(
                            outputs[mod], outputs[combo_key(combo)],
                            scale(f"fcl|{cname}"),
                            mask=sample_mask[mod].bool() & or_mask,
                        )

        outputs["losses"] = losses
        if self.do_fcl:
            fcl_vals = [v for k, v in losses.items() if "fcl" in k]
            nofcl_vals = [v for k, v in losses.items() if "fcl" not in k]
            if fcl_vals:
                outputs["fcl_loss"] = torch.stack(fcl_vals).nan_to_num().mean()
            if nofcl_vals:
                outputs["no-fcl_loss"] = torch.stack(nofcl_vals).nan_to_num().mean()
        stacked = torch.stack(list(losses.values()))
        n_finite = torch.isfinite(stacked).sum().float()
        # NaN pairs are excluded; an all-NaN batch gives the plain (zero) sum
        outputs["loss"] = stacked.nan_to_num().sum() / n_finite.clamp(min=1.0)
        return outputs
