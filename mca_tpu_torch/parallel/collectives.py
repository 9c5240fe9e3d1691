"""The port's collectives, ported from ``mca_tpu/parallel/collectives.py``.

Every cross-rank operation of the port goes through this module; models
and losses never call ``torch.distributed`` themselves.  A ``group`` of
None is an axis of one rank, where each function is the identity.

- :func:`gather_tensor`: the reference's differentiable all-gather of
  the contrastive batch (``utils/distributed.py``), with its three
  gradient modes (:class:`BackpropType`).  ``GLOBAL``'s backward is the
  transpose of the gather, a *sum* reduce-scatter: each rank's rows get
  the sum over ranks of the gradient the loss gives them, which, with
  every rank computing the same global loss, is ``world`` times the
  single-process gradient; the gradient average over ``data`` divides
  it back.  ``NONE`` gathers detached values; ``LOCAL`` re-inserts this
  rank's rows with their gradient.
- Megatron's pair for tensor parallelism over ``model``
  (:func:`copy_to_model`: identity forward, all-reduce backward;
  :func:`reduce_from_model`: all-reduce forward, identity backward), and
  the sequence-parallel forms along a token axis (:func:`gather_seq`,
  :func:`reduce_scatter_seq`, :func:`split_seq`, :func:`gather_seq_out`).
- GPipe's pair over ``pipe`` (:mod:`mca_tpu_torch.parallel.pipeline`):
  :func:`ring_shift` (rank ``i`` receives rank ``i - 1``'s tensor, the
  JAX package's ``ppermute`` over ``[(i, i + 1 mod S)]``; backward: the
  reverse shift) and :func:`last_to_all` (the last stage's tensor on
  every stage, JAX's ``psum(where(s == S - 1, buf, 0))``; backward: the
  last stage's own gradient, since every stage computes the same loss
  from it), and :func:`tie`, which orders a tensor after another in the
  backward graph without touching its value.

The collectives are ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce`` and ``broadcast`` on both backends: gloo takes all four on
CPU and on CUDA tensors (``chip_smoke.py``'s phase 14 (b) probes it),
NCCL on CUDA.  The ring shift is chosen by backend: point to point
(``batch_isend_irecv``) on NCCL and on gloo's CPU tensors, and on gloo's
CUDA tensors, where gloo documents ``send`` / ``recv`` for CPU tensors
only, an ``all_gather`` over ``pipe`` from which each rank takes its
neighbour's block (S times the bytes; phase 15 probes both).
"""

from __future__ import annotations

import enum
from typing import Dict, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


class BackpropType(enum.Enum):
    GLOBAL = 0
    LOCAL = 1
    NONE = 2


def group_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim``, in rank order."""
    if group is None:
        return t
    n = group_size(group)
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of the ranks' ``t``."""
    if group is None:
        return t
    n = group_size(group)
    x = t.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over {n} ranks")
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim)


def all_reduce(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the ranks of ``t``, in place; returns ``t``."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def chunk(t: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return t
    if t.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over {n} ranks")
    return t.chunk(n, dim=dim)[group_rank(group)].contiguous()


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


class _GatherSplit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return chunk(g, ctx.group, ctx.dim), None, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_tensor(
    tensor: torch.Tensor, group: Group, backprop_type: BackpropType = BackpropType.GLOBAL
) -> torch.Tensor:
    """All-gather ``tensor`` over ``group``, concatenated on axis 0:
    ``[world * B, ...]`` (module docstring for the gradient modes)."""
    if group is None:
        return tensor
    if backprop_type == BackpropType.GLOBAL:
        return _AllGather.apply(tensor, group, 0)
    gathered = all_gather(tensor.detach(), group)
    if backprop_type == BackpropType.LOCAL:
        b, r = tensor.shape[0], group_rank(group)
        return torch.cat([gathered[: r * b], tensor, gathered[(r + 1) * b :]])
    return gathered


def global_labels(local_batch_size: int, group: Group, device=None) -> torch.Tensor:
    """Row labels into the gathered batch: ``rank * B + arange(B)``."""
    return group_rank(group) * local_batch_size + torch.arange(local_batch_size, device=device)


def gather_masks(masks: Dict[str, torch.Tensor], group: Group) -> Dict[str, torch.Tensor]:
    """Boolean per-row masks gathered over ``group`` (no gradient)."""
    if group is None:
        return masks
    return {k: all_gather(v.to(torch.uint8), group).bool() for k, v in masks.items()}


def any_rank(flag: bool, device) -> bool:
    """Whether ``flag`` is set on any rank of the world."""
    t = torch.tensor([1.0 if flag else 0.0], device=device)
    return bool(all_reduce(t, dist.group.WORLD).item() > 0)


def copy_to_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's ``f``: the replicated input of column-parallel layers."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Megatron's ``g``: the sum of the row-parallel layers' partials."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_seq(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    """Sequence shards -> the whole sequence, ahead of column-parallel
    layers (backward: the sum reduce-scatter of their partial gradients)."""
    return x if group is None else _AllGather.apply(x, group, dim)


def reduce_scatter_seq(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    """Row-parallel partials of the whole sequence -> this rank's shard of
    their sum (backward: all-gather)."""
    return x if group is None else _ReduceScatter.apply(x, group, dim)


def split_seq(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    """A replicated sequence -> this rank's shard (backward: all-gather of
    the shards' gradients)."""
    return x if group is None else _Split.apply(x, group, dim)


def gather_seq_out(x: torch.Tensor, group: Group, dim: int = 1) -> torch.Tensor:
    """Shards -> the whole sequence, ahead of replicated layers (backward:
    this rank's shard of the gradient, which every rank computes whole)."""
    return x if group is None else _GatherSplit.apply(x, group, dim)


def _shift(t: torch.Tensor, group: Group, step: int) -> torch.Tensor:
    """Rank ``i`` of ``group`` gets rank ``i - step``'s ``t`` (module
    docstring for the route each backend takes)."""
    n, r = group_size(group), group_rank(group)
    x = t.contiguous()
    if dist.get_backend(group) == "gloo" and x.is_cuda:
        return all_gather(x[None], group)[(r - step) % n].clone()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + step) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _LastToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        n = group_size(group)
        ctx.last = group_rank(group) == n - 1
        out = x.detach().clone(memory_format=torch.contiguous_format)
        dist.broadcast(out, dist.get_global_rank(group, n - 1), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.last else torch.zeros_like(g)), None


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, after):
        ctx.after = (after.shape, after.dtype)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.after
        return g, g.new_zeros(shape, dtype=dtype)


def ring_shift(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Rank ``i`` of ``group`` gets rank ``i - 1``'s ``x`` (mod the size);
    the gradient goes the other way round."""
    return x if group is None else _RingShift.apply(x, group)


def last_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The last rank's ``x`` on every rank of ``group``.  The gradient
    reaches the last rank's ``x`` from its own output alone, and the other
    ranks' ``x`` a zero one: every rank must compute the same function of
    the output (the pool and loss, replicated over ``pipe``)."""
    return x if group is None else _LastToAll.apply(x, group)


def tie(x: torch.Tensor, after: torch.Tensor) -> torch.Tensor:
    """``x`` itself, made to depend on ``after`` in the backward graph (a
    zero gradient goes to ``after``), so that ``after``'s backward runs
    after ``x``'s on every rank."""
    return _Tie.apply(x, after)
