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
parameters stay whole on every stage (under ``fsdp``, sliced over the
stage's ``data`` ranks only).  A block's leaves get their
gradient on their own stage only and the encoders and packing tokens on
stage 0 only (:data:`PIPE_PARTIAL`), so those are summed over ``pipe``;
the final norm, the pool and the logit scales get the same gradient on
every stage (each computes the same loss) and are left as they are: a
sum would scale them by the stage count.

**FSDP over ``data``** (ZeRO-3, the JAX package's ``fsdp``:
parameters *and* moments sharded, :class:`ShardedOptimizer`): every leaf
of at least :data:`FSDP_MIN_SIZE` elements (the JAX package's threshold,
counted on the whole leaf, so a tensor- or expert-parallel shard is
sliced further, as ``_fsdp_extend`` turns ``P(None, 'model')`` into
``P('data', 'model')``) lives on a rank only as its ``1 / data`` slice of
the flat leaf: ``ceil(n / data)`` entries, the last rank's zero-padded.
That slice is the ``nn.Parameter`` AdamW steps, and its moments are the
slice's only; the leaf itself is taken out of the model.  Smaller leaves
are replicated and their gradients all-reduced.  AdamW is elementwise,
so the update is the single-process one wherever the leaf lies.

A module group (each block ``layers.{i}``, each encoder
``encoders.{m}``, the attentive pool, and the model's own tokens) gathers
its leaves whole with one ``all_gather`` over ``data`` when its forward
starts (a forward pre-hook), in the dtype its forward reads them (the
blocks' projections in their compute dtype, which is where the
single-process block casts them; the rest fp32), and drops them when
its forward ends.  Autograd does not keep them: a saved-tensor hook, set
around the whole forward, saves a gathered weight (or a view of it) as a
token, and the group's backward gathers it again on its first use.  The
gather is an autograd Function whose backward reduce-scatters the
group's whole gradient into the slices' ``.grad`` (the ``data``
average), which then accumulate over ``grad_accum``'s microbatches; the
gradient whole lives only while the group's backward runs.  Under
``remat`` the checkpoint's own hooks keep nothing inside a block, and
its recomputation gathers the block again.

Every rank of a ``data`` group runs the same graph, so their gathers and
scatters come in one order on each; the sums over ``model`` and over
``pipe`` run on the slices after the backward (:meth:`ShardedOptimizer.
reduce_gradients`), at one point on every rank, since a stage never runs
another stage's blocks and so cannot join a per-block sum over ``pipe``.
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel.mesh import Mesh
from mca_tpu_torch.utils import trace

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
#: leaves a block casts to its compute dtype where it reads them: under
#: ZeRO-3 they are gathered in it
CAST_AT_USE = re.compile(r"^layers\.\d+\.(attn\.(to_q|to_kv|to_out)\.weight|"
                         r"ff\.feedforward\.[02]\.weight|ff\.experts\.(w_in|w_out))$")
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


def module_group(name: str) -> str:
    """The module whose forward gathers leaf ``name`` under ZeRO-3: the
    block ``layers.{i}`` or encoder ``encoders.{m}`` it lies in, else the
    top-level module it lies in, or the model itself ("") for its own
    tokens."""
    parts = name.split(".")
    if parts[0] in ("layers", "encoders"):
        return ".".join(parts[:2])
    return parts[0] if len(parts) > 1 else ""


class _Bucket:
    """The sharded leaves of one module group read in one dtype: what one
    all_gather builds.  ``targets`` are the (module, attribute) pairs the
    whole leaves are set on for the group's forward."""

    def __init__(self, idx: List[int], dtype: torch.dtype, targets: list):
        self.idx, self.dtype, self.targets = idx, dtype, targets


class _Gathered:
    """One gather of a bucket (one forward of its group): the whole leaves
    it built for the backward (None until the backward needs them)."""

    def __init__(self, bucket: _Bucket):
        self.bucket, self.wholes = bucket, None


class _Saved:
    """What autograd keeps of a gathered leaf (or a view of it): where in
    the whole it lies, to be gathered again."""

    def __init__(self, rec: _Gathered, k: int, t: torch.Tensor):
        self.rec, self.k = rec, k
        self.size, self.stride, self.offset = t.size(), t.stride(), t.storage_offset()


class _GatherBucket(torch.autograd.Function):
    """The slices -> the whole leaves (one all_gather over ``data``);
    backward: the whole gradients reduce-scattered into the slices', over
    ``data``, averaged."""

    @staticmethod
    def forward(ctx, opt, rec, *slices):
        ctx.opt, ctx.rec = opt, rec
        return tuple(opt._gather(rec.bucket))

    @staticmethod
    def backward(ctx, *grads):
        ctx.rec.wholes = None
        return (None, None) + tuple(ctx.opt._scatter_grads(ctx.rec.bucket, grads))


class ShardedOptimizer:
    """The optimizer side of a multi-rank step: the leaves each rank
    steps, the gradient reductions (over ``model`` for :data:`SEQ_PARTIAL`
    leaves under ``seq_shard`` and for an expert-parallel block's router,
    over ``pipe`` for :data:`PIPE_PARTIAL` leaves of a pipelined stack,
    the average over ``data``), the global norm over the whole gradient,
    the AdamW step on each rank's part, and whole-state views for
    checkpoints.  ``make(params)`` builds the torch optimizer over
    :attr:`opt_params`: the model's own parameter where a leaf is
    replicated over ``data``, the rank's slice (module docstring) where
    ``fsdp`` shards it, in the model's parameter order, so that its state
    dict has the single-process indices.  Under ``fsdp`` the sharded
    leaves leave the model; ``device`` (if given) then receives the model
    and the slices, so that no whole large leaf reaches it.  The model
    pipelines its stack where it holds a ``pipe_group`` (MCA; EAO runs
    whole on every stage)."""

    def __init__(self, model: nn.Module, mesh: Mesh, make, fsdp: bool = False,
                 seq_shard: bool = False, fsdp_min_size: int = FSDP_MIN_SIZE, device=None):
        self.model, self.mesh = model, mesh
        self.state_keys = list(model.state_dict())
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.shapes = [tuple(p.shape) for _, p in named]
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
                        for (_, p), tp in zip(named, self.tp)]
        # this rank counts a leaf's entries towards a global norm where no
        # other rank holds the same entries (every leaf is whole on every
        # pipe stage)
        self.owned = [(sh or mesh.data_rank == 0) and (tp or mesh.model_rank == 0)
                      and mesh.pipe_rank == 0 for sh, tp in zip(self.sharded, self.tp)]
        # a sharded leaf's flat entries [a, b) are this rank's: blocks of
        # ``chunk`` in rank order, the last ones padded with zeros
        self.chunk = [-(-p.numel() // d) for _, p in named]
        self.span = [(min(mesh.data_rank * c, p.numel()), min((mesh.data_rank + 1) * c, p.numel()))
                     for (_, p), c in zip(named, self.chunk)]
        self.opt_params: List[torch.Tensor] = []
        for i, (n, p) in enumerate(named):
            if not self.sharded[i]:
                self.opt_params.append(p)
                continue
            mine = self._my_chunk(p.detach(), i)
            self.opt_params.append(nn.Parameter(mine if device is None else mine.to(device)))
        self._buckets = self._take_sharded_leaves(named) if any(self.sharded) else []
        del named
        if device is not None:
            model.to(device)
        self._live: Dict[int, tuple] = {}  # a gathered leaf's storage -> (gather, index)
        self._hooks = None
        self.inner = make(self.opt_params)

    # -- ZeRO-3: the sharded leaves out of the model, gathered per group --
    def _take_sharded_leaves(self, named) -> List[_Bucket]:
        """Remove the sharded leaves from their modules, group them into
        buckets (one per module group and gather dtype) and hook each
        group's forward (module docstring)."""
        model = self.model
        compute = getattr(model, "dtype", torch.float32)
        groups: Dict[str, Dict[torch.dtype, _Bucket]] = {}
        for i, (n, _) in enumerate(named):
            if not self.sharded[i]:
                continue
            path, _, attr = n.rpartition(".")
            owner = model.get_submodule(path)
            del owner._parameters[attr]
            object.__setattr__(owner, attr, None)
            dtype = compute if CAST_AT_USE.match(n) else torch.float32
            bucket = groups.setdefault(module_group(n), {}).setdefault(dtype, _Bucket([], dtype, []))
            bucket.idx.append(i)
            bucket.targets.append((owner, attr))
        for path, by_dtype in groups.items():
            module = model.get_submodule(path)
            buckets = list(by_dtype.values())
            module.register_forward_pre_hook(lambda mod, args, b=buckets: self._enter(b))
            module.register_forward_hook(lambda mod, args, out, b=buckets: self._leave(b),
                                         always_call=True)
        # the saved-tensor hooks span the whole forward, outside any
        # checkpoint, whose own hooks then keep nothing inside a block
        model.register_forward_pre_hook(lambda mod, args: self._push_saved_hooks(),
                                        prepend=True)
        model.register_forward_hook(lambda mod, args, out: self._pop_saved_hooks(),
                                    always_call=True)
        return [b for by_dtype in groups.values() for b in by_dtype.values()]

    def _gather_rows(self, mine: torch.Tensor) -> torch.Tensor:
        """``[data, len(mine)]``: every rank's ``mine``, in rank order."""
        return coll.all_gather(mine, self.mesh.data_group).reshape(self.mesh.data, -1)

    def _gather(self, bucket: _Bucket) -> List[torch.Tensor]:
        """The bucket's whole leaves (in its dtype) from every rank's slices."""
        chunks = [self.chunk[i] for i in bucket.idx]
        mine = torch.cat([self.opt_params[i].detach().to(bucket.dtype) for i in bucket.idx])
        rows = self._gather_rows(mine)
        out, off = [], 0
        for i, c in zip(bucket.idx, chunks):
            n = math.prod(self.shapes[i])
            out.append(rows[:, off:off + c].reshape(-1)[:n].view(self.shapes[i]))
            off += c
        return out

    def _scatter_grads(self, bucket: _Bucket, grads) -> List[torch.Tensor]:
        """Each rank's slices of the bucket's whole gradients (zeros where
        a leaf took none), summed over ``data`` and divided by it."""
        d = self.mesh.data
        rows = torch.cat([
            self._padded(torch.zeros(self.shapes[i], device=self.opt_params[i].device)
                         if g is None else g.float(), d * self.chunk[i]).reshape(d, -1)
            for i, g in zip(bucket.idx, grads)
        ], dim=1)  # [d, sum of chunks]: row r holds rank r's slices
        mine = coll.reduce_scatter(rows.reshape(-1), self.mesh.data_group).mul_(1.0 / d)
        return list(mine.split([self.chunk[i] for i in bucket.idx]))

    def _enter(self, buckets: List[_Bucket]) -> None:
        for bucket in buckets:
            rec = _Gathered(bucket)
            slices = [self.opt_params[i] for i in bucket.idx]
            wholes = _GatherBucket.apply(self, rec, *slices)
            for k, ((owner, attr), w) in enumerate(zip(bucket.targets, wholes)):
                object.__setattr__(owner, attr, w)
                self._live[w.untyped_storage().data_ptr()] = (rec, k)

    def _leave(self, buckets: List[_Bucket]) -> None:
        for bucket in buckets:
            for owner, attr in bucket.targets:
                w = getattr(owner, attr)
                if w is not None:
                    self._live.pop(w.untyped_storage().data_ptr(), None)
                object.__setattr__(owner, attr, None)

    def _pack(self, t: torch.Tensor):
        hit = self._live.get(t.untyped_storage().data_ptr()) if t.layout == torch.strided else None
        # detached: a hook that keeps a node's own output would tie the node
        # to itself, and a graph no backward walks (a stage's unused
        # branch) would never be freed
        return t.detach() if hit is None else _Saved(hit[0], hit[1], t)

    def _unpack(self, x):
        if not isinstance(x, _Saved):
            return x
        rec = x.rec
        if rec.wholes is None:  # the group's backward: gathered once more
            rec.wholes = self._gather(rec.bucket)
        return rec.wholes[x.k].as_strided(x.size, x.stride, x.offset)

    def _push_saved_hooks(self) -> None:
        if torch.is_grad_enabled():
            self._hooks = torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack)
            self._hooks.__enter__()

    def _pop_saved_hooks(self) -> None:
        if self._hooks is not None:
            hooks, self._hooks = self._hooks, None
            hooks.__exit__(None, None, None)

    # -- layout helpers -------------------------------------------------
    @staticmethod
    def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
        """``t`` flat, zero-padded to ``n`` entries."""
        flat = t.reshape(-1)
        return torch.cat([flat, flat.new_zeros(n - flat.numel())]) if n > flat.numel() else flat

    def _my_chunk(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's slice of the whole leaf ``t``, padded to ``chunk``."""
        return self._padded(t.reshape(-1)[slice(*self.span[i])], self.chunk[i]).clone()

    def _whole(self, mine: torch.Tensor, i: int) -> torch.Tensor:
        """A sharded leaf's slices gathered over ``data``, in its shape."""
        flat = coll.all_gather(self._padded(mine, self.chunk[i]), self.mesh.data_group)
        return flat[: math.prod(self.shapes[i])].reshape(self.shapes[i])

    # -- the step -------------------------------------------------------
    def reduce_gradients(self) -> None:
        """After the backward (whose per-group scatters averaged the sharded
        leaves' slices over ``data``): sum the partial gradients over
        ``model``, then over ``pipe`` (class docstring), then average the
        replicated leaves' over ``data`` (one all-reduce).  Recorded as
        ``train.grad_reduce``, timed on a CUDA device."""
        grads = self.gradients()
        with trace.span("train.grad_reduce") as sp:
            sp.device_start(grads[0].device)
            partial = [g for g, s in zip(grads, self.model_partial) if s]
            if partial:
                self._all_reduce_flat(partial, self.mesh.model_group)
            staged = [g for g, s in zip(grads, self.pipe_partial) if s]
            if staged:
                self._all_reduce_flat(staged, self.mesh.pipe_group)
            d = self.mesh.data
            repl = [g for g, sh in zip(grads, self.sharded) if not sh]
            if d > 1 and repl:
                self._all_reduce_flat(repl, self.mesh.data_group, scale=1.0 / d)

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
        """AdamW on this rank's leaves and slices, in place; the gradients
        are then dropped, so that between steps a rank holds its
        parameters and moments only."""
        self.inner.step()
        for p in self.opt_params:
            p.grad = None

    # -- whole-state views ----------------------------------------------
    def model_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict (sharded leaves gathered over
        ``data``, tensor-parallel ones over ``model``), on every rank, in
        the model's key order."""
        local = self.model.state_dict()
        index = {n: i for i, n in enumerate(self.names)}
        out = {}
        for k in self.state_keys:
            i = index.get(k)
            v = self._whole(self.opt_params[i].detach(), i) if i is not None and \
                self.sharded[i] else local[k]
            out[k] = tp_unshard(self.layouts.get(k), v, self.mesh.model_group)
        return out

    def load_model_state_dict(self, full: Mapping[str, torch.Tensor]) -> None:
        """In place: the replicated leaves into the model, this rank's slice
        of each sharded one into its slice."""
        shards = shard_state_dict(full, self.mesh)
        with torch.no_grad():
            for i, n in enumerate(self.names):
                if self.sharded[i]:
                    self.opt_params[i].copy_(self._my_chunk(shards.pop(n), i))
        self.model.load_state_dict(shards, strict=True)

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
