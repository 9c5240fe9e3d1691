"""Mixture-of-experts feed-forward with expert-choice routing, ported
from ``mca_tpu/models/moe.py``.

``moe_experts: E`` in a train config replaces every block's GEGLU
:class:`~mca_tpu_torch.models.layers.FeedForward` with ``E`` GEGLU
experts (an extension of the JAX package: the reference's FF is always
dense).  Expert choice (Zhou et al. 2022): each expert takes the top
``C = capacity_factor * T / E`` tokens of each sample by router score,
so the load is balanced by construction and no auxiliary loss is
needed.

- Router: fp32 logits ``x @ router``, a softmax over experts per
  token; padded tokens score exactly 0, so real tokens (whose softmax
  scores are strictly positive) come first, and a padded token that is
  still picked combines with weight 0.
- Top-``C`` per expert with ties taken at the lower token index first,
  as ``jax.lax.top_k`` takes them (a stable descending sort;
  ``torch.topk`` may pick a different *set* among equal scores, and
  ties are common: every padded token scores 0, and with one expert
  every score is 1).
- Each expert is an erf-GELU GEGLU (``w_in`` ``[E, dim, 2 * inner]``,
  u half first; ``w_out`` ``[E, inner, dim]``); outputs are summed over
  the experts that picked a token, weighted by their gates.  A token no
  expert picks gets a zero FF output (the block's residual carries it).
- Routing is per sample: a sample's output never depends on what else
  shares its batch (the serving and ``infer`` contract).

Dispatch gathers the picked tokens and combine scatter-adds the
weighted outputs (``O(E * C * D)`` data movement): the JAX package's
``MCA_MOE_IMPL=gather`` arm.  Its default arm, one-hot dispatch and
combine matmuls (``O(E * C * T * D)`` operations), computes the same
function; on an H100 it is the slower and larger of the two (at
TCGA_config1 with 2 experts, about 62 against 55 ms of device time a
training step and 6.6 against 4.8 GiB at its peak; ``chip_smoke.py``
phase 12 (d)), so the port keeps only the gather.  On the card
``index_add`` sums a token's outputs in the order its atomic adds land:
with at most two experts a token the sum is exact to order, beyond that
the last bits of a bf16 output may vary from run to run.  Both are plain PyTorch
operations: the JAX package computes them in XLA, outside any Pallas
kernel.

Expert parallelism (``model_group`` of ``m`` ranks with ``E % m == 0``,
the JAX rule that shards the stacked expert matrices' expert dim over
``model``; :mod:`mca_tpu_torch.parallel.sharding`): the rank holds
experts ``[r * E / m, (r + 1) * E / m)`` (:meth:`MoEFeedForward.local_experts`).
Every rank routes the whole sample with the replicated router, gathers
and computes its own experts' tokens and ``index_add``s their weighted
outputs; one ``reduce_from_model`` sums the ranks' partial combines in
fp32, rounded once to the compute dtype (one process's ``index_add``
rounds a token's sum there too), and the input passes ``copy_to_model``, whose backward sums the
ranks' partial input gradients (through their experts and through the
router's scores of their experts).  Under ``seq_shard`` the block sees a
token shard, and expert choice needs the whole sequence, so it gathers
the sequence first (``gather_seq``) and reduce-scatters its partials
back to shards.  Where ``E`` does not divide by ``m`` the experts stay
replicated: every rank computes the whole block (under ``seq_shard``
between ``gather_seq_out`` and ``split_seq``).

Parameters keep the JAX package's layout under its extension names
(``mca_tpu/interop.py``): ``router.weight`` ``[dim, E]`` (stored
un-transposed), ``experts.w_in`` and ``experts.w_out``.

``record`` is the routing-statistics hook of
:mod:`mca_tpu_torch.tools.moe_stats` (the JAX package's ``sow``): None,
except while that tool runs, when each call appends its detached
``router_scores`` ``[B, T, E]``, ``token_idx`` and ``gates``
``[B, E, C]``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel.sharding import expert_parallel


def expert_capacity(seq_len: int, num_experts: int, capacity_factor: float) -> int:
    """Tokens each expert takes: ``round(cf * T / E)`` clamped to
    ``[1, T]``."""
    cap = int(round(capacity_factor * seq_len / num_experts))
    return max(1, min(seq_len, cap))


def route(scores: torch.Tensor, capacity: int):
    """Each expert's top-``capacity`` tokens of each sample, ties at the
    lower token index first (``jax.lax.top_k``'s order):
    ``scores [B, T, E] -> (gates, token_idx) [B, E, C]``."""
    gates, token_idx = torch.sort(
        scores.transpose(1, 2), dim=-1, descending=True, stable=True
    )
    return gates[..., :capacity], token_idx[..., :capacity]


class MoEFeedForward(nn.Module):
    """Expert-choice GEGLU mixture of experts, in place of
    ``FeedForward`` (module docstring)."""

    def __init__(
        self,
        dim: int,
        num_experts: int,
        mult: float = 4,
        capacity_factor: float = 2.0,
        dtype: torch.dtype = torch.float32,
        model_group=None,
        seq_shard: bool = False,
    ):
        super().__init__()
        if num_experts < 1:
            raise ValueError(f"num_experts must be at least 1, got {num_experts}")
        inner = int(dim * mult * 2 / 3)
        self.num_experts = int(num_experts)
        self.capacity_factor = float(capacity_factor)
        self.dtype = dtype
        m = coll.group_size(model_group)
        self.model_group = model_group if m > 1 else None
        self.seq_shard = bool(seq_shard) and self.model_group is not None
        self.expert_parallel = expert_parallel(self.num_experts, m)
        n_local = self.num_experts // m if self.expert_parallel else self.num_experts
        self.router = nn.ParameterDict(
            {"weight": nn.Parameter(torch.zeros(dim, num_experts))}
        )
        self.experts = nn.ParameterDict(
            {
                "w_in": nn.Parameter(torch.zeros(n_local, dim, 2 * inner)),
                "w_out": nn.Parameter(torch.zeros(n_local, inner, dim)),
            }
        )
        self.record: Optional[List[dict]] = None

    def local_experts(self) -> Tuple[int, int]:
        """The experts ``[lo, hi)`` this rank holds and computes."""
        if not self.expert_parallel:
            return 0, self.num_experts
        n = self.experts["w_in"].shape[0]
        r = coll.group_rank(self.model_group)
        return r * n, (r + 1) * n

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        group = self.model_group
        if group is None:
            return self._combine(x, padding_mask)
        if self.expert_parallel:
            x = coll.gather_seq(x, group) if self.seq_shard else coll.copy_to_model(x, group)
            out = self._combine(x, padding_mask).float()
            if self.seq_shard:
                out = coll.reduce_scatter_seq(out, group)
            else:
                out = coll.reduce_from_model(out, group)
            # rounded once to the compute dtype, as one process's combine
            return out.to(self.dtype)
        if self.seq_shard:
            return coll.split_seq(self._combine(coll.gather_seq_out(x, group), padding_mask),
                                  group)
        return self._combine(x, padding_mask)

    def _combine(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Route the whole of each sample; this rank's experts' weighted
        outputs, summed per token: ``[B, T, D]`` in the compute dtype."""
        B, T, D = x.shape
        E = self.num_experts
        C = expert_capacity(T, E, self.capacity_factor)
        scores = torch.softmax(x.float() @ self.router["weight"], dim=-1)
        if padding_mask is not None:
            scores = scores.masked_fill(padding_mask[..., None].bool(), 0.0)
        gates, token_idx = route(scores, C)
        if self.record is not None:
            self.record.append(
                {
                    "router_scores": scores.detach(),
                    "token_idx": token_idx.detach(),
                    "gates": gates.detach(),
                }
            )

        lo, hi = self.local_experts()
        gates, token_idx = gates[:, lo:hi], token_idx[:, lo:hi]
        compute = self.dtype
        b_idx = torch.arange(B, device=x.device)[:, None, None]
        xe = x.to(compute)[b_idx, token_idx]  # [B, E, C, D]
        h, gate = torch.einsum(
            "becd,edf->becf", xe, self.experts["w_in"].to(compute)
        ).chunk(2, dim=-1)
        h = F.gelu(gate, approximate="none") * h
        out = torch.einsum("becf,efd->becd", h, self.experts["w_out"].to(compute))
        weighted = gates.to(compute)[..., None] * out
        # a token picked by several experts sums their outputs
        flat = (b_idx * T + token_idx).reshape(-1)
        return torch.zeros(B * T, D, dtype=compute, device=x.device).index_add(
            0, flat, weighted.reshape(-1, D)
        ).view(B, T, D)
