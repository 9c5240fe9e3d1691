"""The contrastive pretraining loss graph, ported from ``mca_tpu/losses.py``.

- :func:`clip_contrastive_loss` — CLIP-style symmetric cross-entropy
  of one pair with a learnable clamped temperature: logits are raw dot
  products (no L2 normalisation, as in the reference) scaled by
  ``exp(clip(logit_scale))``; an optional per-sample bool mask selects
  which *rows* contribute (columns, the negatives, always span the
  batch); an empty mask gives NaN, which the aggregation masks out.  The
  single-pair formula, which the batched graph below is held against.
- :class:`MCAPretrainingLoss` — slices the pooled return tokens into the
  named embeddings, then (unless ``no_loss``) computes every configured
  pair loss under its presence mask, the fusion-channel (FCL) losses
  against the root combo with OR-of-members masks, and the NaN-safe
  aggregates ``fcl_loss``, ``no-fcl_loss`` and ``loss``.  One shared
  temperature (``loss.loss_fn.logit_scale`` in the state dict), or with
  ``separate_modal_loss_fns`` one per pair and per FCL combo, as in the
  JAX package (``loss.logit_scale_{name}``, ``name`` the pair's log name
  or ``fcl|{combo}``, the JAX tree's ``loss/logit_scale_{name}``).

The P losses are one batched graph, in a number of ops that does not
grow with P: a static plan built once from the configuration (each
loss's two token slots, its row mask as the AND of two OR-terms over the
modalities, its temperature) is held in non-persistent buffers; each
call gathers the P pairs' embeddings into ``[P, B, D]`` stacks (fp32),
takes each direction's ``[P, B, B]`` logits from one ``bmm`` (``a @ b.T``
and ``b @ a.T``, as the single-pair formula does: the transpose of the
first holds the second's values summed in another order, so the per-pair
losses stay those of :func:`clip_contrastive_loss` to the bit on the
CPU), one log-softmax over both, then the masked row means and the
aggregates as vectors.  ``outputs["losses"]`` keeps the loop's keys
in the loop's order: the pairs, then per non-root combo ``fcl_fusion|…``
and each ``fcl_{mod}|…``.

Over a ``data_group`` of several ranks (:meth:`MCAPretrainingLoss.gather`)
the pooled tokens and the modality masks are all-gathered before the
loss, with ``GLOBAL`` backprop by default (``backprop``,
:class:`mca_tpu_torch.parallel.collectives.BackpropType`): every rank then
computes the loss of the global batch, whose masked row means divide by
the global count of live rows; that is the JAX package's semantics (the
loss written on the global batch), not the reference's per-rank labels.
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
    combo under FCL, and ``fusion``), then the reference's loss dict,
    all P losses in one batched graph (module docstring)."""

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
        self._build_plan()

    def _build_plan(self) -> None:
        """The static plan of the P losses, in the loop's order: their
        names (``loss_names``), the pairs' count (``n_pairs``: the FCL
        losses follow them), and the buffers ``pair_slots`` ``[2P]`` (each
        loss's a slots, then its b slots, on the pooled-token axis),
        ``pair_terms`` ``[2, P, M]`` (the row mask's two OR-terms over the
        modalities, ANDed; a one-term mask repeats its term) and
        ``pair_scale`` ``[P]`` (each loss's temperature)."""
        names = list(self.modality_names)
        mlen = len(names)
        # the fusion token, or under FCL the root combo's slot (fusion_combos[0])
        slot = {**{m: i for i, m in enumerate(names)}, "fusion": mlen}
        scale_of = {n: i for i, n in enumerate(self.scale_names())} if self.separate else {}
        self._scale_params = [f"logit_scale_{n}" for n in scale_of]
        plan = []  # (name, slot a, slot b, OR-terms, temperature's name)
        for a, b in self._pair_list():
            name = "_".join(sorted((a, b)))
            terms = [{slot[m]} for m in (a, b) if m != "fusion"]
            plan.append((name, slot[a], slot[b], terms, name))
        self.n_pairs = len(plan)
        if self.do_fcl:
            root = self.fusion_combos[0]
            for i, combo in enumerate(self.fusion_combos):
                if combo == root:
                    continue
                cname = combo_log_name(combo, names)
                members = set(combo)
                if not self.no_fusion:
                    plan.append((f"fcl_fusion|{cname}", slot["fusion"], mlen + i, [members],
                                 f"fcl|{cname}"))
                if self.non_fusion_fcl:
                    for j, mod in enumerate(names):
                        plan.append((f"fcl_{mod}|{cname}", j, mlen + i, [{j}, members],
                                     f"fcl|{cname}"))
        self.loss_names = tuple(p[0] for p in plan)
        terms = torch.zeros(2, len(plan), mlen, dtype=torch.bool)
        for k, (_, _, _, ors, _) in enumerate(plan):
            for t, members in enumerate(ors if len(ors) == 2 else ors * 2):
                terms[t, k, sorted(members)] = True
        self.register_buffer(
            "pair_slots", torch.tensor([p[1] for p in plan] + [p[2] for p in plan],
                                       dtype=torch.long), persistent=False)
        self.register_buffer("pair_terms", terms, persistent=False)
        self.register_buffer(
            "pair_scale", torch.tensor([scale_of.get(p[4], 0) for p in plan], dtype=torch.long),
            persistent=False)

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
        n_loss = len(self.loss_names)

        # [M, B] presence, then each loss's rows: (OR of term 0) AND (OR of term 1)
        present = torch.stack([sample_mask[m] for m in names]).bool()
        row_mask = (self.pair_terms[..., None] & present).any(dim=2).all(dim=0).float()
        if self.separate:
            scales = torch.stack([getattr(self, n) for n in self._scale_params])
        else:
            scales = self.loss_fn.logit_scale[None]
        temperature = scales.clamp(LOGIT_SCALE_MIN, LOGIT_SCALE_MAX).exp()[self.pair_scale]
        emb = pooled_tokens.float().transpose(0, 1)[self.pair_slots]  # [2P, B, D]
        emb_a, emb_b = emb[:n_loss], emb[n_loss:]
        # each direction from its own product, as the single-pair formula takes
        # it: (a @ b.T).T holds b @ a.T's values, rounded in another order
        logits = torch.stack([torch.bmm(emb_a, emb_b.transpose(1, 2)),
                              torch.bmm(emb_b, emb_a.transpose(1, 2))])
        logits = logits * temperature[:, None, None]  # [2, P, B, B]: a->b, b->a
        # row i against column i
        row_loss = -logits.log_softmax(dim=-1).diagonal(dim1=-2, dim2=-1)  # [2, P, B]
        cnt = row_mask.sum(dim=-1)
        mean = torch.where(cnt > 0, (row_loss * row_mask).sum(dim=-1) / cnt.clamp(min=1.0),
                           float("nan"))  # NaN where a loss has no live row
        per_loss = (mean[0] + mean[1]) / 2

        outputs["losses"] = dict(zip(self.loss_names, per_loss.unbind()))
        if self.do_fcl:
            if n_loss > self.n_pairs:
                outputs["fcl_loss"] = per_loss[self.n_pairs:].nan_to_num().mean()
            if self.n_pairs:
                outputs["no-fcl_loss"] = per_loss[: self.n_pairs].nan_to_num().mean()
        n_finite = torch.isfinite(per_loss).sum().float()
        # NaN pairs are excluded; an all-NaN batch gives the plain (zero) sum
        outputs["loss"] = per_loss.nan_to_num().sum() / n_finite.clamp(min=1.0)
        return outputs
