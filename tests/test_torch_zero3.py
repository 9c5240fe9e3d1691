"""The port's ZeRO-3 (``fsdp: true``: parameters and moments sharded over
``data``) against the JAX package's fsdp steps, on the CPU at 2 and 4
gloo ranks.

The tiny model of ``tests/test_torch_parallel.py`` (fp32, dense
attention, dropout 0), initialised in JAX and carried into the port,
takes three steps on the same numpy batches at ``data 4 + fsdp`` and at
``data 2 + fsdp + grad_accum 2``, each against JAX's own steps on a
``data`` mesh of forced host devices with ``shard_params(...,
fsdp=True)``: loss and grad_norm at ``RTOL``, the parameters after the
steps at ``RTOL``.  At this width only the feed-forward's ``w_in`` passes
``FSDP_MIN_SIZE``; the ``_all`` runs lower the threshold to
:data:`MIN_SIZE` in the ranks (and in JAX's ``shard_params``), so that
every projection, token table and the pool are sliced too.  The ranks
also report, after every step, what each leaf holds (its slice and its
moments) and whether any whole large leaf is still reachable from the
model, and whether a group's gathered weights outlive its forward
(plainly and under ``remat``).  ``data 2 x pipe 2 + fsdp`` runs in a
launch of its own under a short timeout, so that a deadlock between the
``data`` gathers and the ``pipe`` ring shifts fails fast.
"""

import json
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mca_tpu.parallel.mesh import replicated, shard_batch
from mca_tpu.parallel.sharding import shard_opt_state, shard_params, state_shardings
from mca_tpu.train import hf_lr_schedule, init_state, make_optimizer, make_train_step
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.parallel import launch as launch_lib
from tests.test_torch_parallel import (RTOL, _batches, _cfg, _launch, _port_steps,
                                       assert_metrics_close, one_torch_thread,  # noqa: F401
                                       param_gap)

STEPS = 3
MIN_SIZE = 256  # the ``_all`` runs' fsdp threshold: every large-ish leaf sliced
PIPE_TIMEOUT = 180  # seconds: the pipe layout's launch, a deadlock included

RANK_SCRIPT = r'''
import gc, json, math, sys
import torch
torch.set_num_threads(1)
from torch.multiprocessing.reductions import StorageWeakRef
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.parallel import sharding
from mca_tpu_torch.parallel.multihost import init_multihost, is_primary, make_stager


def use_min_size(min_size):
    """build_trainer's ShardedOptimizer with another fsdp threshold."""
    class Sharded(sharding.ShardedOptimizer):
        def __init__(self, *a, **k):
            super().__init__(*a, fsdp_min_size=min_size, **k)
    port_train.ShardedOptimizer = Sharded


def residency(model, opt):
    """What each leaf holds on this rank, and the whole large leaves (or
    tensors as large) still reachable from the model."""
    d = opt.mesh.data
    leaves = []
    for i, name in enumerate(opt.names):
        n = math.prod(opt.shapes[i])
        st = opt.inner.state.get(opt.opt_params[i], {})
        leaves.append({"name": name, "n": n, "sharded": opt.sharded[i],
                       "held": opt.opt_params[i].numel(),
                       "moments": [st[k].numel() for k in ("exp_avg", "exp_avg_sq")
                                   if k in st]})
    largest_sharded = max([lf["n"] for lf in leaves if lf["sharded"]] or [0])
    smallest_sharded = min([lf["n"] for lf in leaves if lf["sharded"]] or [0])
    reachable = []  # the buffers (masks) aside
    for mod_name, mod in model.named_modules():
        for k, v in vars(mod).items():
            if k == "_buffers":
                continue
            for t in (v.values() if k == "_parameters" else [v]):
                if torch.is_tensor(t) and t.numel() >= smallest_sharded > 0:
                    reachable.append(f"{mod_name}.{k}: {tuple(t.shape)}")
    targets = [getattr(owner, attr) is None for b in opt._buckets for owner, attr in b.targets]
    return {"leaves": leaves, "reachable": reachable, "targets_empty": all(targets),
            "largest_sharded": largest_sharded}


def steps(job):
    if job.get("min_size"):
        use_min_size(job["min_size"])
    cfg = training_config_from_dict(job["config"])
    inputs = torch.load(job["inputs"], weights_only=False)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=job["total"],
                                                 params=inputs["params"])
    stage = make_stager(opt.mesh, int(cfg.batch_size))
    hist, held = [], []
    for b in inputs["batches"]:
        hist.append(port_train.train_step(model, opt, sched, port_train.to_device(stage(b), "cpu"),
                                          clip=float(cfg.clip), n_accum=int(cfg.grad_accum)))
        held.append(residency(model, opt))
    whole = opt.model_state_dict()
    all_held = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(all_held, held)
    if is_primary():
        torch.save({"metrics": hist, "params": whole, "held": all_held}, job["out"])


def saved(job):
    """One forward and backward: how many gathered weights are alive when
    the forward ends, and how often the backward gathered again."""
    use_min_size(job["min_size"])
    cfg = training_config_from_dict(job["config"])
    inputs = torch.load(job["inputs"], weights_only=False)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", params=inputs["params"])
    refs, calls, real_gather = [], [], opt._gather

    def gather(bucket):
        out = real_gather(bucket)
        # the storage itself, which outlives any one tensor object on it
        refs.extend(StorageWeakRef(w.untyped_storage()) for w in out)
        calls.append(bucket)
        return out

    opt._gather = gather
    batch = port_train.to_device(make_stager(opt.mesh, int(cfg.batch_size))(inputs["batches"][0]),
                                 "cpu")
    out = model(batch, no_loss=False,
                generator=port_train.dropout_generator(0, 0, None, "cpu", opt.mesh.data_rank))
    gc.collect()
    res = {"forward_gathers": len(calls), "alive": sum(not r.expired() for r in refs),
           "buckets": len(opt._buckets)}
    out["loss"].backward()
    res["backward_gathers"] = len(calls) - res["forward_gathers"]
    res["alive_after_backward"] = sum(not r.expired() for r in refs)
    res["slice_grads"] = all(opt.opt_params[i].grad is not None
                             for b in opt._buckets for i in b.idx)
    # a forward whose graph no backward walks: dropping its outputs frees
    # its activations
    acts = []
    model.layers[0].register_forward_hook(
        lambda m, a, y: acts.append(StorageWeakRef(y.untyped_storage())))
    out = model(batch, no_loss=False,
                generator=port_train.dropout_generator(0, 1, None, "cpu", opt.mesh.data_rank))
    del out
    gc.collect()
    res["unwalked_graph_freed"] = bool(acts) and all(r.expired() for r in acts)
    if is_primary():
        torch.save(res, job["out"])


init_multihost(device="cpu")
for job in json.load(open(sys.argv[1])):
    globals()[job["kind"]](job)
'''


def _jax_fsdp_steps(cfg_dict, batches, params0, data, n_accum=1, min_size=None):
    """JAX's own steps on a ``data`` mesh of host devices with fsdp, from
    ``params0``."""
    from mca_tpu.parallel.sharding import FSDP_MIN_SIZE

    jcfg = jax_config(cfg_dict)
    mesh = jax_make_mesh(data, 1, devices=jax.devices()[:data])
    model = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS)
    kw = dict(fsdp=True, fsdp_min_size=FSDP_MIN_SIZE if min_size is None else min_size)
    params = shard_params(jax.tree.map(jnp.asarray, params0), mesh, **kw)
    state = {"params": params, "opt_state": shard_opt_state(tx.init(params), mesh, **kw),
             "step": jax.device_put(jnp.zeros((), jnp.int32), replicated(mesh))}
    step = make_train_step(model, tx, schedule, n_accum=n_accum,
                           out_shardings=(state_shardings(state), replicated(mesh)))
    hist = []
    for b in batches:
        state, m = step(state, shard_batch(b, mesh))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, state_dict_from_jax_params(jax.tree.map(np.asarray, jax.device_get(state["params"])))


def _jax_init(cfg_dict, batch):
    jcfg = jax_config(cfg_dict)
    model = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    state = init_state(model, tx, jax.tree.map(jnp.asarray, batch), seed=0)
    return jax.tree.map(np.array, state["params"])


#: name -> (world, config overrides, fsdp threshold or None, JAX's mesh data axis and n_accum)
RUNS = {
    "fsdp4": (4, dict(mesh_data=4, fsdp=True), None, (4, 1)),
    "fsdp4_all": (4, dict(mesh_data=4, fsdp=True), MIN_SIZE, (4, 1)),
    "fsdp2_accum": (2, dict(mesh_data=2, fsdp=True, grad_accum=2), None, (2, 2)),
    "fsdp2_accum_all": (2, dict(mesh_data=2, fsdp=True, grad_accum=2), MIN_SIZE, (2, 2)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs (one launch at 2 ranks, one at 4, and the pipe
    layout's own), started in threads while this process computes JAX's
    fsdp steps."""
    tmp = tmp_path_factory.mktemp("zero3")
    batches = _batches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")
        params0 = _jax_init(_cfg(), batches[0])
        pipe_params0 = _jax_init(_cfg(layers=4), batches[0])
    port_params = state_dict_from_jax_params(params0)
    torch.save({"params": port_params, "batches": batches}, tmp / "inputs.pt")
    torch.save({"params": state_dict_from_jax_params(pipe_params0), "batches": batches},
               tmp / "pipe_inputs.pt")

    def job(kind, name, world_overrides, min_size=None, inputs="inputs.pt", cfg=_cfg):
        out = {"kind": kind, "config": cfg(**world_overrides), "inputs": str(tmp / inputs),
               "total": STEPS, "out": str(tmp / f"{name}.pt")}
        return {**out, "min_size": min_size} if min_size else out

    jobs = {2: [], 4: []}
    for name, (world, over, min_size, _) in RUNS.items():
        jobs[world].append(job("steps", name, over, min_size))
    for name, over in (("saved", {}), ("saved_remat", {"remat": True}),
                       ("saved_bf16", {"precision": "bf16", "attention_impl": "pallas"})):
        jobs[2].append(job("saved", name, dict(mesh_data=2, fsdp=True, **over), MIN_SIZE))

    def pipe_cfg(**o):
        return _cfg(layers=4, **o)

    pipe_jobs = [job("steps", "dp2_pp2_fsdp_all", dict(mesh_data=2, mesh_pipe=2, fsdp=True),
                     MIN_SIZE, "pipe_inputs.pt", pipe_cfg),
                 job("steps", "dp2_pp2_fsdp_remat", dict(mesh_data=2, mesh_pipe=2, fsdp=True,
                                                         remat=True),
                     MIN_SIZE, "pipe_inputs.pt", pipe_cfg)]
    with ThreadPoolExecutor(3) as pool:
        launches = [pool.submit(_launch, tmp, 2, jobs[2], RANK_SCRIPT),
                    pool.submit(_launch, tmp, 4, jobs[4], RANK_SCRIPT),
                    pool.submit(_pipe_launch, tmp, pipe_jobs)]
        refs = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MCA_FUSED_FF", "0")
            for name, (_, over, min_size, (data, n_accum)) in RUNS.items():
                refs[name] = _jax_fsdp_steps(_cfg(**{k: v for k, v in over.items()
                                                     if k == "grad_accum"}),
                                             batches, params0, data, n_accum, min_size)
        pipe_ref = _port_steps(pipe_cfg(), batches, state_dict_from_jax_params(pipe_params0))
        errors = [f.exception() for f in launches]
    return {"tmp": tmp, "refs": refs, "pipe_ref": pipe_ref, "pipe_error": errors[2],
            "errors": errors[:2]}


def _pipe_launch(tmp, jobs) -> None:
    """The pipe layout's jobs at 4 ranks, with :data:`PIPE_TIMEOUT`."""
    script = tmp / "rank_pipe.py"
    script.write_text(RANK_SCRIPT)
    spec = tmp / "jobs_pipe.json"
    spec.write_text(json.dumps(jobs))
    from tests.test_torch_parallel import _rank_env

    launch_lib.launch([sys.executable, str(script), str(spec)], 4, timeout=PIPE_TIMEOUT,
                      env=_rank_env(), log_dir=str(tmp / "logs_pipe"))


def _load(runs, name):
    for e in runs["errors"]:
        if e is not None:
            raise e
    return torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_zero3_steps_match_jax_fsdp(runs, name):
    """Each layout's three steps against JAX's ``shard_params(...,
    fsdp=True)`` steps on the same ``data`` mesh."""
    got = _load(runs, name)
    hist, final = runs["refs"][name]
    assert_metrics_close(got["metrics"], hist)
    assert param_gap(got["params"], final) <= RTOL


@pytest.mark.parametrize("name", ["fsdp4", "fsdp4_all", "fsdp2_accum_all"])
def test_a_rank_holds_its_slices_only(runs, name):
    """After every step each rank's optimizer steps, and holds moments
    for, exactly ``ceil(n / d)`` entries of each sharded leaf and the
    whole of each other one; every leaf of at least the threshold is
    sharded; no whole large leaf (nor a tensor as large) is reachable
    from the model."""
    world, over, min_size, _ = RUNS[name]
    d = over["mesh_data"]
    threshold = min_size or 2 ** 14
    got = _load(runs, name)
    assert len(got["held"]) == world
    for rank_steps in got["held"]:
        assert len(rank_steps) == STEPS
        for held in rank_steps:
            assert held["targets_empty"] and held["reachable"] == [], held["reachable"]
            assert any(lf["sharded"] for lf in held["leaves"])
            for lf in held["leaves"]:
                assert lf["sharded"] == (lf["n"] >= threshold), lf
                want = -(-lf["n"] // d) if lf["sharded"] else lf["n"]
                assert lf["held"] == want, lf
                assert lf["moments"] == [want, want], lf


@pytest.mark.parametrize("name", ["saved", "saved_remat", "saved_bf16"])
def test_gathered_weights_do_not_outlive_their_forward(runs, name):
    """No gathered weight is alive when the forward ends (autograd keeps
    tokens, not the weights) or after the backward; the backward gathers
    a group once more where its backward reads its weights (under
    ``remat`` the checkpoint's recomputation does it for the blocks), at
    most once a group, and every slice gets its gradient; a forward whose
    graph no backward walks leaves nothing alive once its outputs go."""
    got = _load(runs, name)
    assert got["forward_gathers"] == got["buckets"] > 1
    assert got["alive"] == 0 and got["alive_after_backward"] == 0
    assert 0 < got["backward_gathers"] <= got["buckets"]
    assert got["slice_grads"] and got["unwalked_graph_freed"]


@pytest.mark.parametrize("name", ["dp2_pp2_fsdp_all", "dp2_pp2_fsdp_remat"])
def test_zero3_under_the_pipe_fails_fast_or_matches(runs, name):
    """``data 2 x pipe 2 + fsdp`` (every leaf above :data:`MIN_SIZE`
    sliced), plainly and under ``remat``, in a launch whose timeout a
    deadlock would hit, against the same steps in one process."""
    assert runs["pipe_error"] is None, runs["pipe_error"]
    got = torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)
    hist, final = runs["pipe_ref"]
    assert_metrics_close(got["metrics"], hist)
    assert param_gap(got["params"], final) <= RTOL
