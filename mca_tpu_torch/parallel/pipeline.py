"""GPipe over the layer stack, ported from ``mca_tpu/parallel/pipeline.py``.

The mesh's ``pipe`` axis holds ``S`` stages; stage ``s`` runs layers
``[s * L / S, (s + 1) * L / S)`` and the rank's rows are split into
microbatches that flow stage to stage over the ``pipe`` group.  The
schedule has ``M + S - 1`` ticks; at tick ``t`` stage ``s`` runs
microbatch ``t - s`` (stage 0 takes it from the input, a later stage
takes what stage ``s - 1`` sent at the end of tick ``t - 1``), and the
last stage keeps its outputs, which then reach every stage
(:func:`~mca_tpu_torch.parallel.collectives.last_to_all`): the pool and
the loss run replicated over ``pipe``, as in the JAX package.  The
backward is autograd through the same graph (the reverse schedule).

As in JAX, one ring shift a tick carries the activations, and every
tick's send is chained to the previous tick's receive
(:func:`~mca_tpu_torch.parallel.collectives.tie`): every rank's backward
graph then holds the same shifts in the same order, from the last tick
to the first, whichever stage it is.  A bubble tick (no microbatch on
this stage) launches no kernel: it sends a zero tensor, so that the
chain stays the same on every rank; the last tick's shift, whose result
no stage reads, is left out.  So a stage runs its ``L / S`` layers
exactly ``M`` times a forward.  The bubble is ``(S - 1) / (M + S - 1)``
of the ticks.

Microbatches: the JAX package splits the global batch into ``n_micro``
(0 = ``S``) contiguous microbatches and requires the batch to divide by
it.  A data rank holds ``B / data`` rows, which may be fewer than
``n_micro`` or not divide by it; it splits them into
``gcd(B / data, n_micro)`` contiguous microbatches of equal size
(:func:`local_microbatches`), which is ``n_micro`` wherever its rows
divide by ``n_micro``.  Every layer treats each sample alone (attention
and expert choice within a sample, the feed-forward by token), so the
split changes nothing but the order of floating-point work.

The parameters stay whole on every stage (the JAX design: memory comes
from FSDP, compute from the pipe), so checkpoints are those of the
sequential stack.  A layer leaf gets its gradient on its own stage
only, an encoder leaf on stage 0 only; the optimizer sums them over
``pipe`` (:class:`~mca_tpu_torch.parallel.sharding.ShardedOptimizer`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mca_tpu_torch.parallel import collectives as coll


def local_microbatches(n_rows: int, n_micro: int) -> int:
    """How many equal contiguous microbatches a rank splits its
    ``n_rows`` into: ``gcd(n_rows, n_micro)``."""
    return math.gcd(int(n_rows), int(n_micro))


def check_pipeline(depth: int, batch_size: int, n_stages: int, n_micro: int) -> None:
    """The JAX ``pipeline_layers``' asserts, as ``ValueError``: the depth
    must divide by the stages and the (global) batch by the
    microbatches (0 = one a stage)."""
    n_micro = int(n_micro) or int(n_stages)
    if depth % n_stages:
        raise ValueError(f"layers={depth} not divisible by mesh_pipe={n_stages} "
                         "(pipeline stages)")
    if batch_size % n_micro:
        raise ValueError(f"batch_size={batch_size} not divisible by "
                         f"pipeline_microbatches={n_micro}")


def stage_input(stage: int, m: int, xm: Sequence[torch.Tensor],
                recv: torch.Tensor) -> torch.Tensor:
    """What stage ``stage`` runs microbatch ``m`` on: the input's block on
    stage 0, what the previous stage sent otherwise."""
    return xm[m] if stage == 0 else recv


def pipeline_layers(
    layers: Sequence[nn.Module],
    x: torch.Tensor,
    padding: torch.Tensor,
    attn_mask,
    group,
    n_stages: int,
    n_micro: int = 0,
    remat: bool = False,
) -> torch.Tensor:
    """Run ``layers`` over ``x`` ``[B, T, D]`` (this rank's rows, the
    same on every stage) pipelined over ``group`` (module docstring).
    ``layer(x, attn_mask, padding) -> x`` is one block; ``padding``
    ``[B, T]``; ``remat`` recomputes each layer in the backward.
    Returns ``[B, T, D]`` on every stage."""
    depth = len(layers)
    if depth % n_stages:
        raise ValueError(f"layers={depth} not divisible by mesh_pipe={n_stages}")
    if coll.group_size(group) != n_stages:
        raise ValueError(f"the pipe group has {coll.group_size(group)} ranks but "
                         f"pipeline_stages={n_stages}")
    s = coll.group_rank(group)
    per_stage = depth // n_stages
    mine = list(layers)[s * per_stage:(s + 1) * per_stage]
    n_local = local_microbatches(x.shape[0], int(n_micro) or n_stages)
    xm = x.chunk(n_local)
    # copies: K1 takes its key padding 16-byte aligned, which a row
    # offset into [B, T] bools need not be
    pm = [p.clone() for p in padding.chunk(n_local)]

    def stage(h: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
        for layer in mine:
            if remat and torch.is_grad_enabled():
                h = checkpoint(layer, h, attn_mask, pad, use_reentrant=False)
            else:
                h = layer(h, attn_mask, pad)
        return h

    n_ticks = n_local + n_stages - 1
    # a leaf that takes a gradient, so that every shift, a bubble's too,
    # is in the backward graph on every stage
    recv = torch.zeros_like(xm[0]).requires_grad_(torch.is_grad_enabled())
    outs = []
    for t in range(n_ticks):
        m = t - s
        if 0 <= m < n_local:
            y = stage(stage_input(s, m, xm, recv), pm[m])
            if s == n_stages - 1:
                outs.append(y)
        elif t < n_ticks - 1:
            y = torch.zeros_like(recv)
        if t < n_ticks - 1:
            recv = coll.ring_shift(coll.tie(y, recv), group)
    # the chain ends in the output on every stage, so that every stage's
    # backward runs every shift's
    out = coll.tie(torch.cat(outs) if outs else torch.zeros_like(x), recv)
    return coll.last_to_all(out, group)
