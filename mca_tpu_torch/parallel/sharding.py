"""Where each parameter lies on the mesh, ported from ``mca_tpu/parallel/sharding.py``.

**Tensor parallelism over ``model``** (Megatron, by heads): in every
block, ``attn.to_q`` is column-parallel (a rank holds its heads' rows),
``attn.to_kv`` too, where a rank's rows are its heads' rows of k *and*
of v (the weight stacks k over v, so a shard is not a contiguous half),
and ``attn.to_out`` is row-parallel (its heads' columns); each rank runs
the flash kernels on ``heads / model`` heads and one all-reduce (or,
under ``seq_shard``, a reduce-scatter) sums the output projection's
partials.  The GEGLU feed-forward stays replicated: its ``w_in`` stacks
the value half over the gate half and, at TCGA_config1's inner width
1365, no split keeps a whole value / gate pair on each rank.  (The JAX
rules shard ``w_in`` on its 2730 columns because XLA keeps global
semantics over any split; that is not a layout a rank can compute on.)
The attentive pool, encoders, norms and tokens are replicated.

**Expert parallelism over ``model``** (the JAX rules' ``P("model")`` on
the stacked expert matrices): a MoE block's ``experts.w_in`` ``[E, D, 2
* inner]`` and ``experts.w_out`` ``[E, inner, D]`` split their expert
dim, rank ``r`` holding experts ``[r * E / m, (r + 1) * E / m)``, where
``E`` divides by ``m`` (:func:`expert_parallel`); otherwise they stay
replicated, as the JAX divisibility rule leaves them, and the block is a
plain MoE under TP.  The router stays replicated; every rank routes the
whole sample (:mod:`mca_tpu_torch.models.moe`), so the router's gradient
reaches a rank only through its own experts' gates: a partial sum over
``model`` (:data:`ROUTER`).

**``seq_shard``** keeps the residual stream ``[B, T / model, D]`` per
rank between blocks; the norms and the feed-forward then see a shard of
the tokens, so their gradients are partial sums that are added over
``model`` (:data:`SEQ_PARTIAL`).  A MoE block gathers the whole sequence
first (expert choice needs it), so its leaves are not among those.

**GPipe over ``pipe``** (:mod:`mca_tpu_torch.parallel.pipeline`): the
parameters stay whole on every stage.  A block's leaves get their
gradient on their own stage only and the encoders and packing tokens on
stage 0 only (:data:`PIPE_PARTIAL`), so those are summed over ``pipe``;
the final norm, the pool and the logit scales get the same gradient on
every stage (each computes the same loss) and are left as they are: a
sum would scale them by the stage count.

**FSDP over ``data``** (ZeRO's optimizer-state sharding,
:class:`ShardedOptimizer`): every leaf of at least :data:`FSDP_MIN_SIZE`
elements (the JAX package's threshold, counted on the whole leaf) has
its AdamW moments, and its update, only on the rank's ``1 / data`` slice
of the flat leaf: the optimizer steps a view of the model's own leaf, so
there is no second copy of the values.  The gradient comes to that slice
by one reduce-scatter, and the updated slices go back to every rank by
one all-gather a step.  The parameters and the gradient stay whole on
each rank through the forward and backward (the JAX package shards the
parameters too, and XLA gathers them where they are read).  Smaller
leaves are replicated and their gradients all-reduced.  AdamW is
elementwise, so the update is the single-process one wherever the leaf
lies.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel.mesh import Mesh

#: leaves smaller than this stay replicated under fsdp
FSDP_MIN_SIZE = 2 ** 14

#: tensor- and expert-parallel leaves: name pattern -> layout of the
#: rank's shard
TP_RULES = [
    (re.compile(r"^layers\.\d+\.attn\.to_q\.weight$"), "rows"),
    (re.compile(r"^layers\.\d+\.attn\.to_kv\.weight$"), "kv_rows"),
    (re.compile(r"^layers\.\d+\.attn\.to_out\.weight$"), "cols"),
    (re.compile(r"^layers\.\d+\.ff\.experts\.(w_in|w_out)$"), "experts"),
]
#: leaves that act on a sequence shard under seq_shard (a dense
#: feed-forward's; a MoE block's see the whole sequence)
SEQ_PARTIAL = re.compile(r"^layers\.\d+\.(norm\.|ff\.feedforward\.)")
#: a MoE block's router
ROUTER = re.compile(r"^(layers\.\d+\.ff)\.router\.weight$")
#: leaves upstream of (or inside) a pipelined stack: their gradient lies
#: on one stage
PIPE_PARTIAL = re.compile(r"^(layers\.|encoders\.|fusion_tokens$)")


def expert_parallel(n_experts: int, m: int) -> bool:
    """Whether ``n_experts`` experts split over ``m`` model ranks (the JAX
    rule: shard where the axis divides the dim)."""
    return m > 1 and n_experts % m == 0


def tp_layout(name: str) -> Optional[str]:
    for pattern, layout in TP_RULES:
        if pattern.match(name):
            return layout
    return None


def tp_shard(name: str, full: torch.Tensor, m: int, r: int) -> torch.Tensor:
    """Rank ``r``'s shard of the whole leaf ``full`` over ``m`` model
    ranks (the whole leaf where the leaf is replicated)."""
    layout = tp_layout(name) if m > 1 else None
    if layout == "rows":
        return full.reshape(m, -1, full.shape[1])[r].clone()
    if layout == "kv_rows":
        return full.reshape(2, m, -1, full.shape[1])[:, r].reshape(-1, full.shape[1]).clone()
    if layout == "cols":
        return full.reshape(full.shape[0], m, -1)[:, r].clone()
    if layout == "experts" and expert_parallel(full.shape[0], m):
        return full.reshape(m, -1, *full.shape[1:])[r].clone()
    return full


def tp_unshard(layout: Optional[str], local: torch.Tensor, group) -> torch.Tensor:
    """The whole leaf from every model rank's ``local`` shard of
    ``layout`` (a collective on ``group``); ``local`` itself where the
    layout is None or the axis has one rank."""
    m = coll.group_size(group)
    if layout is None or m == 1:
        return local
    parts = coll.all_gather(local.contiguous()[None], group)  # [m, *local]
    if layout == "experts":
        return parts.reshape(-1, *local.shape[1:])
    if layout == "rows":
        return parts.reshape(-1, local.shape[1])
    if layout == "kv_rows":
        return parts.reshape(m, 2, -1, local.shape[1]).transpose(0, 1).reshape(-1, local.shape[1])
    return parts.permute(1, 0, 2).reshape(local.shape[0], -1)


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """A whole state dict -> this rank's tensor-parallel shards."""
    return {k: tp_shard(k, torch.as_tensor(v), mesh.model, mesh.model_rank)
            for k, v in full.items()}


def _expert_parallel_block(model: nn.Module, block: str) -> bool:
    """Whether the MoE block at ``block`` (a module path) splits its
    experts over ``model``."""
    return bool(getattr(model.get_submodule(block), "expert_parallel", False))


class ShardedOptimizer:
    """The optimizer side of a multi-rank step: gradient reduction (over
    ``model`` for :data:`SEQ_PARTIAL` leaves under ``seq_shard`` and for an
    expert-parallel block's router, over ``pipe`` for :data:`PIPE_PARTIAL`
    leaves of a pipelined stack, then the average over ``data``), the
    global norm over the whole gradient, the AdamW step on each rank's
    part, and whole-state views for checkpoints.  ``make(params)`` builds
    the torch optimizer over the leaves this rank updates: the model's
    own parameters where a leaf is replicated over ``data``, the rank's
    slice of the flat leaf (a view) where it is FSDP-sharded, in the
    model's parameter order, so that its state dict has the
    single-process indices.  The model pipelines its stack where it holds
    a ``pipe_group`` (MCA; EAO runs whole on every stage)."""

    def __init__(self, model: nn.Module, mesh: Mesh, make, fsdp: bool = False,
                 seq_shard: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE):
        self.model, self.mesh = model, mesh
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        d, m = mesh.data, mesh.model

        def layout(n: str) -> Optional[str]:
            lay = tp_layout(n) if m > 1 else None
            if lay == "experts" and not _expert_parallel_block(model, n.rsplit(".experts.", 1)[0]):
                return None
            return lay

        def model_partial(n: str) -> bool:
            router = ROUTER.match(n)
            if router:
                return _expert_parallel_block(model, router.group(1))
            return bool(seq_shard and m > 1 and SEQ_PARTIAL.match(n))

        self.layouts = {n: layout(n) for n in self.names}
        self.tp = [self.layouts[n] is not None for n in self.names]
        self.model_partial = [model_partial(n) for n in self.names]
        pipelined = getattr(model, "pipe_group", None) is not None
        self.pipe_partial = [bool(pipelined and PIPE_PARTIAL.match(n)) for n in self.names]
        self.sharded = [bool(fsdp and d > 1 and p.numel() * (m if tp else 1) >= fsdp_min_size)
                        for p, tp in zip(self.params, self.tp)]
        # this rank counts a leaf's entries towards a global norm where no
        # other rank holds the same entries (every leaf is whole on every
        # pipe stage)
        self.owned = [(sh or mesh.data_rank == 0) and (tp or mesh.model_rank == 0)
                      and mesh.pipe_rank == 0 for sh, tp in zip(self.sharded, self.tp)]
        # a sharded leaf's flat entries [a, b) are this rank's: blocks of
        # ``chunk`` in rank order, the last ones shorter (padded in flight)
        self.chunk = [-(-p.numel() // d) for p in self.params]
        self.span = [(min(mesh.data_rank * c, p.numel()), min((mesh.data_rank + 1) * c, p.numel()))
                     for p, c in zip(self.params, self.chunk)]
        self.opt_params: List[torch.Tensor] = [
            p.detach().view(-1)[slice(*self.span[i])] if sh else p
            for i, (p, sh) in enumerate(zip(self.params, self.sharded))
        ]
        self.inner = make(self.opt_params)

    # -- layout helpers -------------------------------------------------
    @staticmethod
    def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
        """``t`` flat, zero-padded to ``n`` entries."""
        flat = t.reshape(-1)
        return torch.cat([flat, flat.new_zeros(n - flat.numel())]) if n > flat.numel() else flat

    def _my_chunk(self, t: torch.Tensor, i: int) -> torch.Tensor:
        return t.reshape(-1)[slice(*self.span[i])].clone()

    def _whole(self, mine: torch.Tensor, i: int) -> torch.Tensor:
        """A sharded leaf's slices gathered over ``data``, in its shape."""
        p = self.params[i]
        flat = coll.all_gather(self._padded(mine, self.chunk[i]), self.mesh.data_group)
        return flat[: p.numel()].reshape(p.shape)

    # -- the step -------------------------------------------------------
    def reduce_gradients(self) -> None:
        """Sum the partial gradients over ``model`` and over ``pipe``
        (class docstring); average every gradient over ``data``: an
        all-reduce for replicated leaves, a reduce-scatter into the
        slice's ``.grad`` for sharded ones."""
        d = self.mesh.data
        partial = [p.grad for p, s in zip(self.params, self.model_partial) if s]
        if partial:
            self._all_reduce_flat(partial, self.mesh.model_group)
        staged = [p.grad for p, s in zip(self.params, self.pipe_partial) if s]
        if staged:
            self._all_reduce_flat(staged, self.mesh.pipe_group)
        if d == 1:
            return
        repl = [p.grad for p, sh in zip(self.params, self.sharded) if not sh]
        if repl:
            self._all_reduce_flat(repl, self.mesh.data_group, scale=1.0 / d)
        idx = [i for i, sh in enumerate(self.sharded) if sh]
        if idx:
            rows = torch.cat([self._padded(self.params[i].grad, d * self.chunk[i]).reshape(d, -1)
                              for i in idx],
                             dim=1)  # [d, sum of chunks]: row r holds rank r's slices
            mine = coll.reduce_scatter(rows.reshape(-1), self.mesh.data_group).mul_(1.0 / d)
            for i, g in zip(idx, mine.split([self.chunk[i] for i in idx])):
                a, b = self.span[i]
                self.opt_params[i].grad = g[: b - a]

    @staticmethod
    def _all_reduce_flat(grads: List[torch.Tensor], group, scale: float = 1.0) -> None:
        flat = coll.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
        if scale != 1.0:
            flat.mul_(scale)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))

    def gradients(self) -> List[torch.Tensor]:
        """The gradients the optimizer reads (slices where sharded)."""
        return [p.grad for p in self.opt_params]

    def global_norm(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        """sqrt of the sum of squares over the whole set: each rank adds
        the entries it alone holds (``owned``), summed over every rank."""
        zero = tensors[0].new_zeros((), dtype=torch.float32)  # a rank may own none
        local = torch.stack([t.float().square().sum() if own else zero
                             for t, own in zip(tensors, self.owned)]).sum()
        return coll.all_reduce(local.reshape(1), dist.group.WORLD).reshape(()).sqrt()

    def step(self) -> None:
        """AdamW on this rank's leaves and slices (in place, in the model's
        own leaves), then every rank's slices into every rank's leaves
        (one all-gather over ``data``)."""
        self.inner.step()
        idx = [i for i, sh in enumerate(self.sharded) if sh]
        if not idx:
            return
        with torch.no_grad():
            mine = torch.cat([self._padded(self.opt_params[i], self.chunk[i]) for i in idx])
            rows = coll.all_gather(mine, self.mesh.data_group).reshape(self.mesh.data, -1)
            for i, cols in zip(idx, rows.split([self.chunk[i] for i in idx], dim=1)):
                p = self.params[i]
                p.copy_(cols.reshape(-1)[: p.numel()].view_as(p))

    # -- whole-state views ----------------------------------------------
    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict (tensor-parallel leaves gathered
        over ``model``), on every rank."""
        return {k: tp_unshard(self.layouts.get(k), v, self.mesh.model_group)
                for k, v in self.model.state_dict().items()}

    def load_model_state_dict(self, full: Mapping[str, torch.Tensor]) -> None:
        # in place: the optimizer's slices are views of these leaves
        self.model.load_state_dict(shard_state_dict(full, self.mesh), strict=True)

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer's state dict as one process holds it: every moment
        whole (gathered over ``data`` and ``model``), the same indices."""
        sd = self.inner.state_dict()
        state = {}
        for i, st in sd["state"].items():
            st = dict(st)
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0:
                    if self.sharded[i]:
                        v = self._whole(v, i)
                    st[k] = tp_unshard(self.layouts[self.names[i]], v, self.mesh.model_group)
            state[i] = st
        return {"state": state, "param_groups": sd["param_groups"]}

    def load_state_dict(self, full: Mapping[str, Any]) -> None:
        state = {}
        for i, st in full["state"].items():
            st = dict(st)
            i = int(i)
            for k, v in st.items():
                if torch.is_tensor(v) and v.dim() > 0:
                    v = tp_shard(self.names[i], v, self.mesh.model, self.mesh.model_rank)
                    st[k] = self._my_chunk(v, i) if self.sharded[i] else v
            state[i] = st
        self.inner.load_state_dict({"state": state, "param_groups": full["param_groups"]})
