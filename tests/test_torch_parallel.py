"""The port's data and tensor parallelism against the JAX package, on the
CPU at 2 and 4 gloo ranks.

The tiny model (three tabular modalities of widths 12 / 8 / 10, 8 fusion
tokens, dim 64, depth 2, 4 heads x 16, fp32, dense attention, dropout
0) is initialised in JAX and carried into the port; both take the same
three steps on the same numpy batches: two of 8 rows from
``make_tcga_like`` and one in which the rows of the first data rank all
lack ``protein``, so that rank holds no live row of any ``protein``
pair.  The reference is the JAX package's single-device step; the
target layout (``data 2 x model 2 + fsdp + seq_shard``) is also held to
JAX's own step on a 2 x 2 mesh of forced host devices.

The ranks are processes started by ``mca_tpu_torch.parallel.launch``
(a ``file://`` rendezvous in ``tmp_path``, a hard timeout); they import
only torch and the port, read the weights and batches the test process
wrote, run :data:`RANK_SCRIPT`'s jobs and write their results back.
One launch at each world size runs every job of that size; one more
runs the training CLI at 2 ranks.  The flash route (plain versions on
the CPU) under TP, EAO on a mesh, ``train()`` checkpoints across world
sizes and ``infer`` at 2 ranks are held to the port in one process.
"""

import json
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like as jax_make_tcga_like
from mca_tpu.data.synthetic import tiny_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.parallel.collectives import BackpropType as JaxBackprop
from mca_tpu.parallel.collectives import gather_tensor as jax_gather_tensor
from mca_tpu.parallel.collectives import global_labels as jax_global_labels
from mca_tpu.train import hf_lr_schedule, init_state, make_optimizer, make_train_step
from mca_tpu_torch import infer as port_infer
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.parallel import launch as launch_lib
from mca_tpu_torch.parallel import mesh as mesh_lib
from mca_tpu_torch.parallel import multihost, sharding

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTHS = {"gene": 12, "protein": 8, "mirna": 10}
STEPS = 3
RTOL = 1e-4  # fp32 on both sides, sums in another order across ranks
LAUNCH_TIMEOUT = 240  # seconds for all the jobs of one world size
GATHER_ROWS, GATHER_DIM = 8, 5
RUN_ROWS = 32  # train(): 24 train rows (3 steps an epoch), 8 eval rows
EAO_KW = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
              fusion_combos=[2], fcl_root=[0, 1])

RANK_SCRIPT = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from mca_tpu_torch import infer as port_infer, train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel.mesh import make_mesh
from mca_tpu_torch.parallel.multihost import (init_multihost, is_primary, local_rows,
                                              make_stager, process_index)


class StopRun(Exception):
    pass


def gather(job):
    mesh = make_mesh(0, 1, device="cpu")
    d = np.load(job["inputs"])
    x, w = d["x"], torch.from_numpy(d["w"])
    res = {}
    for mode in ("GLOBAL", "LOCAL", "NONE"):
        xt = torch.tensor(x[local_rows(len(x), mesh)], requires_grad=True)
        g = coll.gather_tensor(xt, mesh.data_group, coll.BackpropType[mode])
        if g.requires_grad:
            (g * w).sum().backward()
        res[mode + "/value"] = g.detach().numpy()
        res[mode + "/grad"] = (torch.zeros_like(xt) if xt.grad is None else xt.grad).numpy()
    res["labels"] = coll.global_labels(len(x) // mesh.data, mesh.data_group).numpy()
    np.savez(job["out"] + f".rank{process_index()}.npz", **res)


def steps(job):
    cfg = training_config_from_dict(job["config"])
    inputs = torch.load(job["inputs"], weights_only=False)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=job["total"],
                                                 params=inputs["params"] if job["jax_weights"]
                                                 else None)
    if job.get("backprop"):
        model.loss.backprop = coll.BackpropType[job["backprop"]]
    stage = make_stager(opt.mesh, int(cfg.batch_size))
    hist = [port_train.train_step(model, opt, sched, port_train.to_device(stage(b), "cpu"),
                                  clip=float(cfg.clip), n_accum=int(cfg.grad_accum))
            for b in inputs["batches"]]
    whole = opt.model_state_dict()
    moments = opt.state_dict()
    if is_primary():
        torch.save({"metrics": hist, "params": whole, "optimizer": moments}, job["out"])


def train(job):
    cfg = training_config_from_dict(job["config"])
    rows = port_train.synthetic_rows(cfg, job["rows"], seed=0)

    def log(rec):
        if job.get("stop_after_eval") and "val_epoch_total_loss" in rec:
            raise StopRun

    try:
        port_train.train(cfg, "cpu", rows=rows, log=log)
    except StopRun:
        pass


def infer(job):
    cfg = training_config_from_dict(job["config"])
    port_infer.infer(cfg, "cpu", rows=port_train.synthetic_rows(cfg, job["rows"], seed=0))


init_multihost(device="cpu")
for job in json.load(open(sys.argv[1])):
    globals()[job["kind"]](job)
'''


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**overrides):
    base = tiny_config(
        "tcga", widths=WIDTHS, batch_size=8, layers=2, hidden=64, heads=4, dim_head=16,
        num_fusion_tokens=8, fusion_combos=(3, 2), fcl_root=[0, 1, 2], num_warmup_steps=1,
        fuse_optimizer=False, dropout=0.0,
    )
    return {**base, **overrides}


def _batches():
    """Three collated batches of 8 rows; in the third, rows 0-3 (data rank
    0 of 2, ranks 0 and 1 of 4) lack ``protein`` and rows 4-7 hold every
    modality."""
    rows = jax_make_tcga_like(16, widths=WIDTHS, p_missing=0.25, seed=0)
    odd = jax_make_tcga_like(8, widths=WIDTHS, p_missing=0.0, seed=1)
    for r in odd[:4]:
        r["protein"]["values"] = np.full_like(r["protein"]["values"], -10000.0)
    collate = JaxCollator(jax_config(_cfg()).modality_config.to_plain())
    return [collate(rows[:8]), collate(rows[8:]), collate(odd)]


def _jax_steps(cfg_dict, batches, n_accum=1):
    """JAX's single-device steps: ``(initial params, metrics per step,
    final params)`` as numpy trees."""
    jcfg = jax_config(cfg_dict)
    model = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS)
    bj = [jax.tree.map(jnp.asarray, b) for b in batches]
    state = init_state(model, tx, bj[0], seed=0)
    params0 = jax.tree.map(np.array, state["params"])
    step = make_train_step(model, tx, schedule, n_accum=n_accum)
    hist = []
    for b in bj:
        state, m = step(state, b)
        hist.append({k: float(v) for k, v in m.items()})
    return params0, hist, jax.tree.map(np.asarray, state["params"])


def _jax_mesh_steps(cfg_dict, batches, params0):
    """JAX's own step on a 2 x 2 ('data', 'model') mesh of host devices,
    with fsdp and seq_shard, from ``params0``."""
    from mca_tpu.parallel.mesh import make_mesh, replicated, shard_batch
    from mca_tpu.parallel.sharding import shard_opt_state, shard_params, state_shardings

    jcfg = jax_config(cfg_dict)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    model = jax_build_model(dict(jax_model_config(jcfg), seq_shard=True, seq_shard_mesh=mesh))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS)
    params = shard_params(jax.tree.map(jnp.asarray, params0), mesh, fsdp=True)
    state = {"params": params,
             "opt_state": shard_opt_state(tx.init(params), mesh, fsdp=True),
             "step": jax.device_put(jnp.zeros((), jnp.int32), replicated(mesh))}
    step = make_train_step(model, tx, schedule,
                           out_shardings=(state_shardings(state), replicated(mesh)))
    hist = []
    for b in batches:
        state, m = step(state, shard_batch(b, mesh))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, jax.tree.map(np.asarray, jax.device_get(state["params"]))


def _jax_gather(x, w, n):
    """Per device of an ``n``-device axis: the gathered values and the
    gradient of ``sum(gathered * w)`` for each backprop mode."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()[:n]), ("data",))
    labels = jax.jit(shard_map(lambda xl: jax_global_labels(xl.shape[0], "data"), mesh=mesh,
                               in_specs=P("data"), out_specs=P("data"), check_vma=False))(x)
    out = {"labels": np.asarray(labels)}
    for mode in ("GLOBAL", "LOCAL", "NONE"):
        def body(xl, wl, mode=mode):
            def loss(v):
                return (jax_gather_tensor(v, "data", JaxBackprop[mode]) * wl).sum()
            g = jax_gather_tensor(xl, "data", JaxBackprop[mode])
            return g[None], jax.grad(loss)(xl)

        g, grad = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P()),
                                    out_specs=(P("data"), P("data")), check_vma=False))(x, w)
        out[mode] = (np.asarray(g), np.asarray(grad))
    return out


def _launch(tmp: pathlib.Path, world: int, jobs: list, rank_script: str = RANK_SCRIPT) -> None:
    """``rank_script``'s jobs on ``world`` ranks (one launch, a hard timeout)."""
    script = tmp / f"rank{world}.py"
    script.write_text(rank_script)
    spec = tmp / f"jobs{world}.json"
    spec.write_text(json.dumps(jobs))
    launch_lib.launch([sys.executable, str(script), str(spec)], world,
                      timeout=LAUNCH_TIMEOUT, env=_rank_env(), log_dir=str(tmp / f"logs{world}"))


def _rank_env() -> dict:
    return {"PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


def _run_cfg(out_dir, **overrides):
    """The train() / infer() runs: 32 synthetic rows (seed 0, as the CLI's
    ``--synthetic`` draws them from ``seed``), split 0.25, 2 epochs of 3
    steps, the flash path (plain versions on the CPU)."""
    return _cfg(attention_impl="pallas", epochs=2, seed=0, output_dir=str(out_dir), **overrides)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the tests read: the JAX references, then one launch at
    2 ranks and one at 4, then the world-1 halves of the cross-world
    checks in this process."""
    tmp = tmp_path_factory.mktemp("parallel")
    batches = _batches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")
        params0, ref, ref_final = _jax_steps(_cfg(), batches)
        _, ref_accum, ref_accum_final = _jax_steps(_cfg(grad_accum=2), batches, n_accum=2)
        mesh_hist, mesh_final = _jax_mesh_steps(_cfg(), batches, params0)
    port_params = state_dict_from_jax_params(params0)
    torch.save({"params": port_params, "batches": batches}, tmp / "inputs.pt")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((GATHER_ROWS, GATHER_DIM)).astype(np.float32)
    w = rng.standard_normal((GATHER_ROWS, GATHER_DIM)).astype(np.float32)
    np.savez(tmp / "gather.npz", x=x, w=w)
    jax_gather = {n: _jax_gather(x, w, n) for n in (2, 4)}

    # world 1: the unbroken run, and its epoch-0 checkpoint for world 4
    _train_here(_run_cfg(tmp / "w1"))
    _train_here(_run_cfg(tmp / "w1stop"), stop_after_eval=True)

    def steps(name, **overrides):
        return {"kind": "steps", "config": _cfg(**overrides), "inputs": str(tmp / "inputs.pt"),
                "total": STEPS, "out": str(tmp / f"{name}.pt"),
                "jax_weights": not overrides.get("eao")}  # EAO: the seed's weights

    jobs2 = [
        {"kind": "gather", "inputs": str(tmp / "gather.npz"), "out": str(tmp / "gather2")},
        steps("dp2", mesh_data=2),
        steps("dp2_accum", mesh_data=2, grad_accum=2),
        {**steps("dp2_none", mesh_data=2), "backprop": "NONE"},
        steps("fsdp2", mesh_data=2, fsdp=True),
        steps("tp2", mesh_model=2),
        steps("tp2_flash", mesh_model=2, attention_impl="pallas"),
        steps("eao2", mesh_data=2, attention_impl="pallas", **EAO_KW),
        _run_job("train", tmp / "w2stop", stop_after_eval=True, mesh_data=2),
        _run_job("infer", tmp / "infer2", mesh_data=2, restart=str(tmp / "w1")),
    ]
    jobs4 = [
        {"kind": "gather", "inputs": str(tmp / "gather.npz"), "out": str(tmp / "gather4")},
        steps("dp4", mesh_data=4),
        steps("target4", mesh_data=2, mesh_model=2, fsdp=True, seq_shard=True),
        steps("eao4", mesh_data=2, mesh_model=2, fsdp=True, attention_impl="pallas", **EAO_KW),
        _run_job("train", tmp / "w4restart", mesh_data=2, mesh_model=2, fsdp=True,
                 restart=str(tmp / "w1stop" / "0")),
    ]
    _launch(tmp, 2, jobs2)
    _launch(tmp, 4, jobs4)
    # the training CLI itself at 2 ranks
    import yaml

    cli_cfg = _run_cfg(tmp / "cli2", mesh_data=2)
    (tmp / "cli.yaml").write_text(yaml.safe_dump(cli_cfg, sort_keys=False))  # modality order
    launch_lib.launch([sys.executable, "-m", "mca_tpu_torch.train", str(tmp / "cli.yaml"),
                       "--device", "cpu", "--synthetic", str(RUN_ROWS)], 2,
                      timeout=LAUNCH_TIMEOUT, env=_rank_env(), log_dir=str(tmp / "logs_cli"))

    # world 1: the restart of the world-2 checkpoint, and infer
    _train_here(_run_cfg(tmp / "w1restart", restart=str(tmp / "w2stop" / "0")))
    cfg = training_config_from_dict(_run_cfg(tmp / "infer1", restart=str(tmp / "w1")))
    port_infer.infer(cfg, "cpu", rows=port_train.synthetic_rows(cfg, RUN_ROWS, seed=0))

    # the flash route's and EAO's references: the same steps in this process
    flash_ref = _port_steps(_cfg(attention_impl="pallas"), batches, port_params)
    eao_ref = _port_steps(_cfg(attention_impl="pallas", **EAO_KW), batches)
    return {"tmp": tmp, "ref": ref, "ref_final": state_dict_from_jax_params(ref_final),
            "ref_accum": ref_accum, "ref_accum_final": state_dict_from_jax_params(ref_accum_final),
            "mesh_hist": mesh_hist, "mesh_final": state_dict_from_jax_params(mesh_final),
            "jax_gather": jax_gather, "x": x, "w": w, "batches": batches,
            "flash_ref": flash_ref, "eao_ref": eao_ref}


def _port_steps(cfg_dict, batches, params=None):
    """The port's steps in this process: ``(metrics, final state dict)``;
    without ``params`` the weights are the config's seed's, as the ranks
    draw them."""
    cfg = training_config_from_dict(cfg_dict)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=STEPS,
                                                 params=params)
    hist = [port_train.train_step(model, opt, sched, port_train.to_device(b, "cpu"),
                                  clip=float(cfg.clip)) for b in batches]
    return hist, model.state_dict()


def _run_job(kind, out_dir, stop_after_eval=False, **overrides):
    job = {"kind": kind, "config": _run_cfg(out_dir, **overrides), "rows": RUN_ROWS,
           "out": str(out_dir)}
    if stop_after_eval:
        job["stop_after_eval"] = True
    return job


class _StopRun(Exception):
    pass


def _train_here(cfg_dict, stop_after_eval=False):
    """``train()`` in this process (world 1) on the runs' rows; with
    ``stop_after_eval`` the run ends at its first eval record, after the
    epoch-0 checkpoint."""
    def log(rec):
        if stop_after_eval and "val_epoch_total_loss" in rec:
            raise _StopRun

    cfg = training_config_from_dict(cfg_dict)
    try:
        port_train.train(cfg, "cpu", rows=port_train.synthetic_rows(cfg, RUN_ROWS, seed=0), log=log)
    except _StopRun:
        pass


def _load(runs, name):
    return torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)


def assert_metrics_close(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for i, (p, j) in enumerate(zip(got, want)):
        for k in ("total_loss", "fcl_loss", "no-fcl_loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(p[k], j[k], rtol=rtol, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(p["lr"], j["lr"], rtol=1e-6, err_msg=f"step {i} lr")
        for k in j:  # the per-pair losses, NaN where the global batch lacks the pair
            if k in p and np.isnan(j[k]):
                assert np.isnan(p[k]), (i, k)
            elif k in p:
                np.testing.assert_allclose(p[k], j[k], rtol=rtol, atol=1e-6, err_msg=f"{i} {k}")


def param_gap(got, want) -> float:
    """The largest entry gap of any leaf, relative to the leaf's largest
    entry."""
    assert got.keys() == want.keys()
    return max(float((torch.as_tensor(got[k]).float() - torch.as_tensor(want[k]).float())
                     .abs().max() / torch.as_tensor(want[k]).abs().max().clamp(min=1e-12))
               for k in want)


# -- no ranks -------------------------------------------------------------


def test_mesh_of_one_process_and_its_refusals():
    assert mesh_lib.make_mesh(0, 1, batch_size=8) is mesh_lib.SINGLE
    assert mesh_lib.make_mesh(1, 1) is mesh_lib.SINGLE
    with pytest.raises(ValueError, match="mesh_data=2 x mesh_model=1 needs 2 ranks"):
        mesh_lib.make_mesh(2, 1)
    with pytest.raises(ValueError, match="mesh_model=2"):
        mesh_lib.make_mesh(0, 2)
    with pytest.raises(ValueError, match="mesh_data=1 x mesh_model=1 x mesh_pipe=2 needs 2 "
                                         "ranks; the world has 1"):
        mesh_lib.make_mesh(1, 1, pipe=2)
    assert not multihost.init_multihost(device="cpu")  # no environment: a no-op
    assert multihost.process_count() == 1 and multihost.is_primary()
    batch = {"m": {"values": np.arange(8)}}
    assert multihost.make_stager(mesh_lib.SINGLE, 8)(batch) is batch


def test_multihost_environment_is_checked(monkeypatch):
    """The JAX package's validation: a rank outside the world raises;
    a multi-process mesh that idles ranks or splits the batch unevenly
    is refused before the first batch."""
    monkeypatch.setenv("MCA_COORDINATOR", "localhost:1")
    monkeypatch.setenv("MCA_NUM_PROCESSES", "2")
    monkeypatch.setenv("MCA_PROCESS_ID", "2")
    with pytest.raises(ValueError, match=r"MCA_PROCESS_ID=2 must be set to a rank in \[0, 2\)"):
        multihost.init_multihost(device="cpu")
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    with pytest.raises(ValueError, match="mesh uses 2 of 4 ranks"):
        multihost.check_mesh_alignment(mesh_lib.Mesh(data=2), 8)
    with pytest.raises(ValueError, match="batch 6 not divisible by data axis 4"):
        multihost.make_stager(mesh_lib.Mesh(data=4), 6)
    multihost.check_mesh_alignment(mesh_lib.Mesh(data=2, model=2), 8)
    with pytest.raises(ValueError, match="explicit output_dir"):
        multihost.require_output_dir({"output_dir": ""})


def test_torchrun_environment_joins_the_group():
    """``MCA_MULTIHOST=auto`` joins through ``env://`` (torchrun's
    MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = ("import os; os.environ['RANK'] = os.environ['MCA_PROCESS_ID']; "
            "import torch.distributed as dist; "
            "from mca_tpu_torch.parallel.multihost import init_multihost; "
            "assert init_multihost(device='cpu'); "
            "print(dist.get_rank(), dist.get_world_size(), dist.get_backend())")
    outs = launch_lib.launch([sys.executable, "-c", code], 2, timeout=120,
                             env={**_rank_env(), "MCA_MULTIHOST": "auto", "WORLD_SIZE": "2",
                                  "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)})
    assert [o.split()[-3:] for o in outs] == [["0", "2", "gloo"], ["1", "2", "gloo"]]


def test_local_rows_follow_the_data_coordinate():
    for world, data, model in ((2, 2, 1), (4, 2, 2), (4, 4, 1)):
        blocks = []
        for r in range(world):
            m = mesh_lib.Mesh(data=data, model=model, data_rank=r // model, model_rank=r % model)
            blocks.append(multihost.local_rows(8, m))
        per = 8 // data
        assert blocks == [slice((r // model) * per, (r // model + 1) * per) for r in range(world)]
    with pytest.raises(ValueError, match="not divisible by 3"):
        multihost.local_rows(8, mesh_lib.Mesh(data=3))


@pytest.mark.parametrize("name,shape", [
    ("layers.0.attn.to_q.weight", (64, 32)),
    ("layers.1.attn.to_kv.weight", (128, 32)),
    ("layers.0.attn.to_out.weight", (32, 64)),
    ("layers.0.ff.feedforward.0.weight", (170, 32)),
])
def test_tensor_parallel_shards_hold_their_heads(name, shape):
    """Each of 4 model ranks holds its heads' rows of q, of k *and* of v,
    and its heads' columns of the output projection; the feed-forward is
    replicated."""
    full = torch.randn(shape)
    parts = [sharding.tp_shard(name, full, 4, r) for r in range(4)]
    layout = sharding.tp_layout(name)
    if layout is None:
        assert all(p is full for p in parts)
        return
    heads = full.reshape(2, 4, -1, shape[1]) if layout == "kv_rows" else None
    for r, p in enumerate(parts):
        if layout == "rows":
            assert torch.equal(p, full[16 * r : 16 * (r + 1)])
        elif layout == "kv_rows":
            assert torch.equal(p[:16], heads[0, r]) and torch.equal(p[16:], heads[1, r])
        else:
            assert torch.equal(p, full[:, 16 * r : 16 * (r + 1)])
    stacked = torch.stack(parts)
    if layout == "rows":
        back = stacked.reshape(-1, shape[1])
    elif layout == "kv_rows":
        back = stacked.reshape(4, 2, -1, shape[1]).transpose(0, 1).reshape(-1, shape[1])
    else:
        back = stacked.permute(1, 0, 2).reshape(shape[0], -1)
    assert torch.equal(back, full)


def test_launch_ends_every_rank_of_a_failed_or_hung_run(tmp_path):
    """A rank that fails ends the others at once; ranks that outlive the
    timeout are ended too; both raise with each rank's output."""
    hang = [sys.executable, "-c",
            "import os, time; print('rank', os.environ['MCA_PROCESS_ID'], flush=True); "
            "time.sleep(0 if os.environ['MCA_PROCESS_ID'] == '1' else 60); "
            "raise SystemExit(int(os.environ['MCA_PROCESS_ID']))"]
    with pytest.raises(launch_lib.LaunchError, match="(?s)rank 1 exited 1.*rank 0"):
        launch_lib.launch(hang, 2, timeout=30)
    with pytest.raises(launch_lib.LaunchError, match="still running after 1 s"):
        launch_lib.launch([sys.executable, "-c", "import time; time.sleep(60)"], 2, timeout=1)
    outs = launch_lib.launch([sys.executable, "-c",
                              "import os; print(os.environ['MCA_NUM_PROCESSES'])"], 2)
    assert [o.strip() for o in outs] == ["2", "2"]


# -- 2 and 4 ranks ----------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("mode", ["GLOBAL", "LOCAL", "NONE"])
def test_gather_tensor_matches_jax(runs, world, mode):
    """Values in rank order on every rank; GLOBAL's gradient is the sum
    reduce-scatter (``world`` times each rank's rows of ``w``), LOCAL's
    the rank's own rows, NONE's zero: each as JAX's ``gather_tensor``
    under ``shard_map`` gives it, device by device."""
    want_values, want_grads = runs["jax_gather"][world][mode]
    per = GATHER_ROWS // world
    for r in range(world):
        got = np.load(runs["tmp"] / f"gather{world}.rank{r}.npz")
        np.testing.assert_array_equal(got[mode + "/value"], want_values[r])
        np.testing.assert_allclose(got[mode + "/grad"], want_grads[r * per : (r + 1) * per],
                                   rtol=1e-6)
    if mode == "GLOBAL":
        np.testing.assert_allclose(want_grads, world * runs["w"], rtol=1e-6)
        # the rows' labels in the gathered batch, rank by rank
        want = runs["jax_gather"][world]["labels"]
        for r in range(world):
            got = np.load(runs["tmp"] / f"gather{world}.rank{r}.npz")["labels"]
            np.testing.assert_array_equal(got, want[r * per : (r + 1) * per])


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_jax(runs, world):
    got = _load(runs, f"dp{world}")
    assert_metrics_close(got["metrics"], runs["ref"])
    assert param_gap(got["params"], runs["ref_final"]) <= RTOL


def test_dp_pair_absent_from_one_rank_uses_global_counts(runs):
    """In the third batch data rank 0 holds no live ``protein`` row: the
    pair losses still match the single-device ones, which divide by the
    global count of live rows."""
    b = runs["batches"][2]
    live = (b["protein"]["values"] != -10000).any(axis=1)
    assert not live[:4].any() and live[4:].all()
    got = _load(runs, "dp2")["metrics"][2]
    want = runs["ref"][2]
    pairs = [k for k in want if "protein" in k and "|" not in k and "fcl" not in k]
    assert pairs
    for k in pairs:
        assert np.isfinite(want[k])
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL)


def test_dp_grad_accum_matches_jax(runs):
    """``grad_accum: 2`` at 2 ranks: each rank's block strided by 2 is the
    global microbatch JAX takes."""
    got = _load(runs, "dp2_accum")
    assert_metrics_close(got["metrics"], runs["ref_accum"])
    assert param_gap(got["params"], runs["ref_accum_final"]) <= RTOL


def test_none_gather_fault_fails(runs):
    """The planted fault: the loss gather with ``BackpropType.NONE`` sends
    no gradient to the rows; the step must fall outside the bound."""
    got = _load(runs, "dp2_none")
    gaps = [abs(p["grad_norm"] - j["grad_norm"]) / j["grad_norm"]
            for p, j in zip(got["metrics"], runs["ref"])]
    assert max(gaps) > 100 * RTOL, gaps
    assert param_gap(got["params"], runs["ref_final"]) > 100 * RTOL


def test_fsdp_matches_jax(runs):
    got = _load(runs, "fsdp2")
    assert_metrics_close(got["metrics"], runs["ref"])
    assert param_gap(got["params"], runs["ref_final"]) <= RTOL
    # the whole moments come back in the single-process layout
    dp = _load(runs, "dp2")["optimizer"]
    for i, st in got["optimizer"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].shape == dp["state"][i][k].shape
            torch.testing.assert_close(st[k], dp["state"][i][k], rtol=1e-4, atol=1e-7)


def test_fsdp_shards_the_large_leaves():
    """At the test's width the feed-forward matrices pass FSDP_MIN_SIZE
    and shard over 2 data ranks; the norms and tokens stay replicated."""
    cfg = training_config_from_dict(_cfg())
    model = port_train.build_trainer(cfg, "cpu")[0]
    big = {n for n, p in model.named_parameters() if p.numel() >= sharding.FSDP_MIN_SIZE}
    assert any(".ff.feedforward.0." in n for n in big)
    assert not any(n.endswith("gamma") or "logit_scale" in n for n in big)


@pytest.mark.parametrize("rank", [0, 1])
def test_fsdp_steps_the_model_leaves_in_place(rank):
    """Under fsdp (ZeRO-3) the optimizer steps the rank's resident slice of
    each sharded leaf, ``ceil(n / 2)`` entries that the two ranks' slices
    tile (the last one zero-padded); the leaf itself has left the model,
    and the moments are the slice's only."""
    cfg = training_config_from_dict(_cfg())

    def sliced(r):
        model = port_train.build_trainer(cfg, "cpu")[0]
        whole = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = sharding.ShardedOptimizer(model, mesh_lib.Mesh(data=2, data_rank=r),
                                        lambda ps: port_train.make_adamw(ps, cfg), fsdp=True)
        return model, opt, whole

    model, opt, whole = sliced(rank)
    other = sliced(1 - rank)[1]
    sharded = [i for i, sh in enumerate(opt.sharded) if sh]
    assert sharded
    names = {n for n, _ in model.named_parameters()}
    before = [p.detach().clone() for p in opt.opt_params]
    for i in sharded:
        name, mine, c = opt.names[i], opt.opt_params[i], opt.chunk[i]
        n = whole[name].numel()
        assert c == -(-n // 2) and mine.numel() == c and name not in names
        pair = (mine, other.opt_params[i]) if rank == 0 else (other.opt_params[i], mine)
        tiled = torch.cat([t.detach() for t in pair])
        assert torch.equal(tiled[:n], whole[name].reshape(-1))  # the ranks tile the leaf
        assert not tiled[n:].any()  # the padding
        mine.grad = torch.ones_like(mine)
    for i in range(len(opt.opt_params)):
        if not opt.sharded[i]:
            assert opt.opt_params[i] is dict(model.named_parameters())[opt.names[i]]
            opt.opt_params[i].grad = torch.zeros_like(opt.opt_params[i])
    opt.inner.step()
    for i in sharded:
        assert not torch.equal(opt.opt_params[i].detach(), before[i])  # stepped in place
        st = opt.inner.state[opt.opt_params[i]]
        assert st["exp_avg"].numel() == opt.chunk[i]  # the moments are the slice's only


def test_tp_matches_jax(runs):
    got = _load(runs, "tp2")
    assert_metrics_close(got["metrics"], runs["ref"])
    assert param_gap(got["params"], runs["ref_final"]) <= RTOL


def test_tp_flash_route_matches_one_process(runs):
    """TP at 2 ranks through the flash path (2 heads a rank, the plain
    versions on the CPU) against the same steps in one process."""
    got = _load(runs, "tp2_flash")
    want, want_final = runs["flash_ref"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL


@pytest.mark.parametrize("name", ["eao2", "eao4"])
def test_eao_on_a_mesh_matches_one_process(runs, name):
    """EAO (ten unmasked passes of the shared blocks at full size here,
    three pairs at this width) at ``data 2`` and at ``data 2 x model 2 +
    fsdp``, through the flash path, against one process."""
    got = _load(runs, name)
    want, want_final = runs["eao_ref"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL


def test_target_config_matches_jax(runs):
    """``data 2 x model 2 + fsdp + seq_shard`` (configs/tcga_parallel.yaml
    at tiny width) against JAX's single-device steps and JAX's own steps
    on a 2 x 2 mesh."""
    got = _load(runs, "target4")
    assert_metrics_close(got["metrics"], runs["ref"])
    assert param_gap(got["params"], runs["ref_final"]) <= RTOL
    assert_metrics_close(got["metrics"], runs["mesh_hist"])
    assert param_gap(got["params"], runs["mesh_final"]) <= RTOL


def _final_params(directory):
    return torch.load(pathlib.Path(directory) / "model" / "model.pt", weights_only=True)


def _step_losses(directory):
    with open(pathlib.Path(directory) / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    return [r["total_loss"] for r in recs if "total_loss" in r]


def test_checkpoint_at_world_2_restarts_at_world_1(runs):
    """Epoch 0 at 2 ranks, then ``restart:`` from its checkpoint at one
    process: three more steps, equal to the unbroken world-1 run."""
    tmp = runs["tmp"]
    assert (tmp / "w2stop" / "0" / "state" / "state.pt").exists()
    assert len(_step_losses(tmp / "w2stop")) == 3
    np.testing.assert_allclose(_step_losses(tmp / "w1restart"), _step_losses(tmp / "w1")[3:],
                               rtol=RTOL)
    assert param_gap(_final_params(tmp / "w1restart"), _final_params(tmp / "w1")) <= RTOL


def test_checkpoint_at_world_1_restarts_at_world_4(runs):
    """And the reverse: the world-1 epoch-0 checkpoint restarted on
    ``data 2 x model 2 + fsdp`` (whole state sharded on load)."""
    tmp = runs["tmp"]
    np.testing.assert_allclose(_step_losses(tmp / "w4restart"), _step_losses(tmp / "w1")[3:],
                               rtol=RTOL)
    assert param_gap(_final_params(tmp / "w4restart"), _final_params(tmp / "w1")) <= RTOL


def test_train_cli_at_two_ranks(runs):
    """``python -m mca_tpu_torch.train`` under the launcher at 2 ranks
    (``mesh_data: 2``): rank 0 alone writes the log, one record a step,
    and the final model equals the world-1 run's."""
    tmp = runs["tmp"]
    assert len(_step_losses(tmp / "cli2")) == 6
    np.testing.assert_allclose(_step_losses(tmp / "cli2"), _step_losses(tmp / "w1"), rtol=RTOL)
    assert param_gap(_final_params(tmp / "cli2"), _final_params(tmp / "w1")) <= RTOL
    assert (tmp / "cli2" / "model.safetensors").exists()


def test_infer_at_world_2_matches_world_1(runs):
    """Rank 0 writes the files one process writes: the same keys, row
    order, masks and labels, embeddings at 1e-5."""
    tmp = runs["tmp"]
    for split in ("train", "eval"):
        one = {k: port_infer.load_embedding_file(str(tmp / "infer1" / f"{split}_{k}"))
               for k in ("embeddings", "masks")}
        two = {k: port_infer.load_embedding_file(str(tmp / "infer2" / f"{split}_{k}"))
               for k in ("embeddings", "masks")}
        assert one["embeddings"].keys() == two["embeddings"].keys()
        assert one["masks"].keys() == two["masks"].keys()
        for k in one["masks"]:
            np.testing.assert_array_equal(two["masks"][k], one["masks"][k])
        for k in one["embeddings"]:
            np.testing.assert_allclose(two["embeddings"][k], one["embeddings"][k], atol=1e-5)
        labels = [port_infer.load_label_file(str(tmp / d / f"{split}_labels"))
                  for d in ("infer2", "infer1")]
        np.testing.assert_array_equal(*labels)
