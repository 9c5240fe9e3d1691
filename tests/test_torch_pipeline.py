"""The port's GPipe pipelining (``mesh_pipe``, ``pipeline_microbatches``)
against the JAX package, on the CPU at 2 and 4 gloo ranks.

``pipeline_layers`` alone: a toy stack of 8 ``tanh`` layers (the JAX
package's ``tests/test_pipeline.py`` toy, padding that differs by
microbatch) at pipe 2 and 4 and microbatches S and 2S, its forward and
its gradients against JAX's ``pipeline_layers`` and against the port's
sequential stack.  The MCA step: the tiny model of
``tests/test_torch_parallel.py`` at depth 4 (fp32, dense attention,
dropout 0), initialised in JAX and carried into the port, three steps on
the same numpy batches, against JAX's own pipelined step on forced host
devices (``tests/test_pipeline.py``'s) at ``pipe 2``, ``data 2 x pipe 2
+ fsdp``, ``model 2 x pipe 2`` and ``pipe 4``: loss and grad_norm at
``RTOL``, the parameters after the steps at JAX's own rtol 2e-4 / atol
2e-5.  MoE through the pipe against ``tests/test_moe.py``'s pipelined
loss; EAO (which ignores the pipe) and the flash route (plain versions,
bf16) against one process; the ranks' coordinates against JAX's device
grid; the configurations the port accepts and refuses against those
JAX's mesh and pipeline asserts accept and refuse; a checkpoint at pipe
2 restarted at world 1; the training CLI at 2 ranks.

The JAX references are computed in this process while the ranks run
(``parallel.launch``, a ``file://`` rendezvous in ``tmp_path``, a hard
timeout).
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
from mca_tpu.parallel.pipeline import pipeline_layers as jax_pipeline_layers
from mca_tpu.parallel.sharding import shard_opt_state, shard_params, state_shardings
from mca_tpu.train import hf_lr_schedule, init_state, make_optimizer, make_train_step
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.parallel import launch as launch_lib
from mca_tpu_torch.parallel import mesh as mesh_lib
from mca_tpu_torch.parallel import multihost
from mca_tpu_torch.parallel.pipeline import local_microbatches, pipeline_layers
from tests.test_pipeline import _layer as jax_toy_layer
from tests.test_pipeline import _toy as jax_toy
from tests.test_torch_parallel import (EAO_KW, LAUNCH_TIMEOUT, RTOL, RUN_ROWS, _batches, _cfg,
                                       _final_params, _launch, _port_steps, _rank_env, _run_cfg,
                                       _step_losses, _train_here, assert_metrics_close,
                                       one_torch_thread, param_gap)  # noqa: F401 (autouse)

STEPS = 3
LAYERS = 4
TOY_CASES = [(2, 2), (2, 4), (4, 4), (4, 8)]  # (stages, microbatches)
#: name -> (data, model, pipe, fsdp): JAX's own pipelined step on host devices
LAYOUTS = {"pipe2": (1, 1, 2, False), "dp2_pp2_fsdp": (2, 1, 2, True),
           "tp2_pp2": (1, 2, 2, False), "pipe4": (1, 1, 4, False)}
MOE_KW = dict(moe_experts=2, moe_capacity_factor=2.0)

RANK_SCRIPT = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.parallel import collectives as coll
from mca_tpu_torch.parallel import pipeline
from mca_tpu_torch.parallel.mesh import make_mesh
from mca_tpu_torch.parallel.multihost import init_multihost, is_primary, make_stager


class Toy(torch.nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w, self.b = torch.nn.Parameter(w), torch.nn.Parameter(b)

    def forward(self, x, attn_mask, pad):
        return torch.tanh(x @ self.w + self.b) * (~pad)[..., None]


class StopRun(Exception):
    pass


def toy(job):
    mesh = make_mesh(1, 1, pipe=job["stages"], device="cpu")
    d = np.load(job["inputs"])
    layers = [Toy(torch.from_numpy(w), torch.from_numpy(b)) for w, b in zip(d["w"], d["b"])]
    x = torch.tensor(d["x"], requires_grad=True)
    y = pipeline.pipeline_layers(layers, x, torch.from_numpy(d["pad"]), None, mesh.pipe_group,
                                 job["stages"], job["micro"])
    (y ** 2).sum().backward()
    grads = [x.grad if x.grad is not None else torch.zeros_like(x)]
    grads += [p.grad if p.grad is not None else torch.zeros_like(p)
              for l in layers for p in (l.w, l.b)]
    flat = coll.all_reduce(torch.cat([g.reshape(-1) for g in grads]), mesh.pipe_group)
    if is_primary():
        torch.save({"y": y.detach(), "grads": flat}, job["out"])


def coords(job):
    res = {}
    for data, model, pipe in job["layouts"]:
        mesh = make_mesh(data, model, pipe=pipe, device="cpu")
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, (mesh.data_rank, mesh.model_rank, mesh.pipe_rank))
        res[f"{data}x{model}x{pipe}"] = got
    if is_primary():
        json.dump(res, open(job["out"], "w"))


def late_stage(model, opt):
    """Stage 1 runs on the activation of the microbatch before its own."""
    real, held = pipeline.stage_input, [None]

    def late(stage, m, xm, recv):
        if stage != 1:
            return real(stage, m, xm, recv)
        out = torch.zeros_like(recv) if m == 0 else held[0]
        held[0] = recv
        return out

    pipeline.stage_input = late


def summed_replicated(model, opt):
    """The pool, final-norm and logit-scale gradients summed over pipe."""
    real = opt.reduce_gradients

    def faulty():
        real()
        opt._all_reduce_flat([g for g, s in zip(opt.gradients(), opt.pipe_partial) if not s],
                             opt.mesh.pipe_group)

    opt.reduce_gradients = faulty


def steps(job):
    cfg = training_config_from_dict(job["config"])
    inputs = torch.load(job["inputs"], weights_only=False)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=job["total"],
                                                 params=inputs["params"] if job["jax_weights"]
                                                 else None)
    real_input = pipeline.stage_input
    if job.get("fault"):
        globals()[job["fault"]](model, opt)
    stage = make_stager(opt.mesh, int(cfg.batch_size))
    hist = [port_train.train_step(model, opt, sched, port_train.to_device(stage(b), "cpu"),
                                  clip=float(cfg.clip))
            for b in inputs["batches"]]
    pipeline.stage_input = real_input
    whole = opt.model_state_dict()
    if is_primary():
        torch.save({"metrics": hist, "params": whole}, job["out"])


def train(job):
    cfg = training_config_from_dict(job["config"])

    def log(rec):
        if job.get("stop_after_eval") and "val_epoch_total_loss" in rec:
            raise StopRun

    try:
        port_train.train(cfg, "cpu", rows=port_train.synthetic_rows(cfg, job["rows"], seed=0),
                         log=log)
    except StopRun:
        pass


init_multihost(device="cpu")
for job in json.load(open(sys.argv[1])):
    globals()[job["kind"]](job)
'''


def _toy_inputs():
    """The JAX toy: 8 layers of width 16, 8 rows of 6 tokens, padding that
    differs by microbatch."""
    params, x, _ = jax_toy()
    pad = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (8, 6)) < 0.3)
    return jax.tree.map(np.asarray, params), np.asarray(x), pad


def _jax_toy(params, x, pad, stages, micro):
    """JAX's ``pipeline_layers`` on ``stages`` host devices: the output and
    the gradient of ``sum(y ** 2)`` w.r.t. x, then each layer's w and b,
    flat in the ranks' order."""
    mesh = jax_make_mesh(1, 1, devices=jax.devices()[:stages], pipe=stages)

    def f(p, x_):
        return jax_pipeline_layers(jax_toy_layer, p, x_, pad, mesh, n_stages=stages, n_micro=micro)

    y = jax.jit(f)(params, x)
    gp, gx = jax.jit(jax.grad(lambda p, x_: jnp.sum(f(p, x_) ** 2), argnums=(0, 1)))(params, x)
    flat = [np.asarray(gx).reshape(-1)]
    for i in range(params["w"].shape[0]):
        flat += [np.asarray(gp["w"][i]).reshape(-1), np.asarray(gp["b"][i]).reshape(-1)]
    return np.asarray(y), np.concatenate(flat)


def _port_sequential_toy(params, x, pad):
    """The port's sequential stack of the same layers (no ranks)."""
    w = [torch.tensor(a, requires_grad=True) for a in params["w"]]
    b = [torch.tensor(a, requires_grad=True) for a in params["b"]]
    h = xt = torch.tensor(x, requires_grad=True)
    padt = torch.tensor(pad)
    for wi, bi in zip(w, b):
        h = torch.tanh(h @ wi + bi) * (~padt)[..., None]
    (h ** 2).sum().backward()
    flat = [xt.grad.reshape(-1)] + [g for wi, bi in zip(w, b)
                                    for g in (wi.grad.reshape(-1), bi.grad.reshape(-1))]
    return h.detach().numpy(), torch.cat(flat).numpy()


def _jax_pipelined_steps(cfg_dict, batches, params0, layout):
    """JAX's own pipelined steps on host devices (``tests/test_pipeline.py``)."""
    data, model_axis, pipe, fsdp = layout
    jcfg = jax_config(cfg_dict)
    mesh = jax_make_mesh(data, model_axis, devices=jax.devices()[:data * model_axis * pipe],
                         pipe=pipe)
    model = jax_build_model(dict(jax_model_config(jcfg), pipeline_stages=pipe,
                                 pipeline_mesh=mesh))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS)
    params = shard_params(jax.tree.map(jnp.asarray, params0), mesh, fsdp=fsdp)
    state = {"params": params, "opt_state": shard_opt_state(tx.init(params), mesh, fsdp=fsdp),
             "step": jax.device_put(jnp.zeros((), jnp.int32), replicated(mesh))}
    step = make_train_step(model, tx, schedule,
                           out_shardings=(state_shardings(state), replicated(mesh)))
    hist = []
    for b in batches:
        state, m = step(state, shard_batch(b, mesh))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, jax.tree.map(np.asarray, jax.device_get(state["params"]))


def _jax_moe_pipelined_loss(cfg_dict, batch):
    """``tests/test_moe.py``'s pipelined MoE forward: its loss, and the
    initial parameters."""
    jcfg = jax_config(cfg_dict)
    mc = jax_model_config(jcfg)
    bj = jax.tree.map(jnp.asarray, batch)
    params = jax.jit(jax_build_model(mc).init)(jax.random.key(0), bj)
    mesh = jax_make_mesh(1, 1, devices=jax.devices()[:2], pipe=2)
    model = jax_build_model(dict(mc, pipeline_stages=2, pipeline_mesh=mesh))
    loss = float(jax.jit(lambda p, b: model.apply(p, b)["loss"])(params, shard_batch(batch, mesh)))
    return loss, jax.tree.map(np.asarray, params)


def _jax_init(cfg_dict, batch):
    jcfg = jax_config(cfg_dict)
    model = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    state = init_state(model, tx, jax.tree.map(jnp.asarray, batch), seed=0)
    return jax.tree.map(np.array, state["params"])


def _pipe_cfg(**overrides):
    return _cfg(layers=LAYERS, **overrides)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' runs (one launch at 2 ranks, one at 4, the CLI at 2),
    started in threads while this process computes the JAX references
    and the one-process runs."""
    tmp = tmp_path_factory.mktemp("pipeline")
    batches = _batches()
    toy_params, toy_x, toy_pad = _toy_inputs()
    np.savez(tmp / "toy.npz", w=toy_params["w"], b=toy_params["b"], x=toy_x, pad=toy_pad)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")
        params0 = _jax_init(_pipe_cfg(), batches[0])
        moe_loss, moe_params0 = _jax_moe_pipelined_loss(_pipe_cfg(**MOE_KW), batches[0])
    torch.save({"params": state_dict_from_jax_params(params0), "batches": batches},
               tmp / "inputs.pt")
    torch.save({"params": state_dict_from_jax_params(moe_params0), "batches": batches},
               tmp / "moe_inputs.pt")

    def steps(name, inputs="inputs.pt", jax_weights=True, **overrides):
        return {"kind": "steps", "config": _pipe_cfg(**overrides), "inputs": str(tmp / inputs),
                "total": STEPS, "out": str(tmp / f"{name}.pt"), "jax_weights": jax_weights}

    def toy(stages, micro):
        return {"kind": "toy", "stages": stages, "micro": micro, "inputs": str(tmp / "toy.npz"),
                "out": str(tmp / f"toy{stages}_{micro}.pt")}

    jobs2 = [toy(2, 2), toy(2, 4),
             {"kind": "coords", "layouts": [[1, 1, 2], [2, 1, 1], [1, 2, 1]],
              "out": str(tmp / "coords2.json")},
             steps("pipe2", mesh_pipe=2),
             steps("pipe2_late", mesh_pipe=2) | {"fault": "late_stage"},
             steps("pipe2_summed", mesh_pipe=2) | {"fault": "summed_replicated"},
             steps("moe_pipe2", "moe_inputs.pt", mesh_pipe=2, **MOE_KW),
             steps("eao_pipe2", jax_weights=False, mesh_pipe=2, attention_impl="pallas", **EAO_KW),
             steps("flash_pipe2", jax_weights=False, mesh_pipe=2, attention_impl="pallas",
                   precision="bf16"),
             {"kind": "train", "config": _run_cfg(tmp / "w2stop", mesh_pipe=2),
              "rows": RUN_ROWS, "stop_after_eval": True}]
    jobs4 = [toy(4, 4), toy(4, 8),
             {"kind": "coords", "layouts": [[1, 1, 4], [2, 1, 2], [1, 2, 2], [2, 2, 1]],
              "out": str(tmp / "coords4.json")},
             steps("pipe4", mesh_pipe=4),
             steps("dp2_pp2_fsdp", mesh_data=2, mesh_pipe=2, fsdp=True),
             steps("tp2_pp2", mesh_model=2, mesh_pipe=2),
             steps("dp2_pp2_m8", mesh_data=2, mesh_pipe=2, pipeline_microbatches=8)]
    import yaml

    cli_cfg = _run_cfg(tmp / "cli2", mesh_pipe=2)
    (tmp / "cli.yaml").write_text(yaml.safe_dump(cli_cfg, sort_keys=False))  # modality order
    with ThreadPoolExecutor(3) as pool:
        launches = [pool.submit(_launch, tmp, 2, jobs2, RANK_SCRIPT),
                    pool.submit(_launch, tmp, 4, jobs4, RANK_SCRIPT),
                    pool.submit(launch_lib.launch,
                                [sys.executable, "-m", "mca_tpu_torch.train", str(tmp / "cli.yaml"),
                                 "--device", "cpu", "--synthetic", str(RUN_ROWS)], 2,
                                timeout=LAUNCH_TIMEOUT, env=_rank_env(),
                                log_dir=str(tmp / "logs_cli"))]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MCA_FUSED_FF", "0")
            jax_toys = {c: _jax_toy(toy_params, toy_x, toy_pad, *c) for c in TOY_CASES}
            jax_steps = {name: _jax_pipelined_steps(_pipe_cfg(), batches, params0, layout)
                         for name, layout in LAYOUTS.items()}
        _train_here(_run_cfg(tmp / "w1"))
        moe_ref = _port_steps(_pipe_cfg(**MOE_KW), batches, state_dict_from_jax_params(moe_params0))
        eao_ref = _port_steps(_pipe_cfg(attention_impl="pallas", **EAO_KW), batches)
        flash_ref = _port_steps(_pipe_cfg(attention_impl="pallas", precision="bf16"), batches)
        for f in launches:
            f.result()
    # world 1: the restart of the pipe-2 checkpoint
    _train_here(_run_cfg(tmp / "w1restart", restart=str(tmp / "w2stop" / "0")))
    return {"tmp": tmp, "jax_toys": jax_toys, "toy": (toy_params, toy_x, toy_pad),
            "jax_steps": {k: (h, state_dict_from_jax_params(p)) for k, (h, p) in jax_steps.items()},
            "moe_loss": moe_loss, "moe_ref": moe_ref, "eao_ref": eao_ref, "flash_ref": flash_ref}


def _load(runs, name):
    return torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)


def assert_params_close(got, want):
    """Every leaf at JAX's own pipeline tolerance (rtol 2e-4, atol 2e-5)."""
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(torch.as_tensor(got[k]).numpy(),
                                   torch.as_tensor(want[k]).numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=k)


# -- no ranks -------------------------------------------------------------


@pytest.mark.parametrize("n_rows", range(1, 13))
def test_local_microbatches_split_every_block_evenly(n_rows):
    """A rank's block of ``n_rows`` splits into equal microbatches, all of
    its rows once; ``n_micro`` of them wherever the block divides by it."""
    for n_micro in range(1, 9):
        k = local_microbatches(n_rows, n_micro)
        assert n_rows % k == 0 and n_micro % k == 0
        if n_rows % n_micro == 0:
            assert k == n_micro
        rows = torch.arange(n_rows)
        assert torch.equal(torch.cat(rows.chunk(k)), rows)
        assert len({len(c) for c in rows.chunk(k)}) == 1


def test_microbatch_padding_is_aligned_for_the_kernel():
    """Each microbatch's key padding starts 16-byte aligned (K1 refuses
    another): 2548 bools a row put a two-row block 8 bytes off."""
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x, attn_mask, pad):
            seen.append((pad.data_ptr() % 16, pad.is_contiguous(), tuple(pad.shape)))
            return x

    x = torch.zeros(8, 2548, 4)
    pad = torch.zeros(8, 2548, dtype=torch.bool)
    y = pipeline_layers([Probe()], x, pad, None, None, 1, 4)
    assert torch.equal(y, x)
    assert seen == [(0, True, (2, 2548))] * 4


def test_tie_gives_after_a_zero_gradient():
    """``tie`` passes ``x``'s gradient through and gives ``after`` an
    explicit zero one, so that ``after``'s backward (a ring shift's, in
    the pipeline) runs on every rank."""
    from mca_tpu_torch.parallel import collectives as coll

    x = torch.randn(3, requires_grad=True)
    after = torch.randn(2, 2, dtype=torch.float64, requires_grad=True)
    (2 * coll.tie(x, after)).sum().backward()
    assert torch.equal(x.grad, torch.full((3,), 2.0))
    assert after.grad is not None and torch.equal(after.grad, torch.zeros(2, 2, dtype=torch.float64))


def _jax_accepts(batch, data, pipe, micro, layers, world) -> bool:
    """Whether JAX's mesh, batch placement and ``pipeline_layers`` take the
    configuration on ``world`` host devices (traced, not run)."""
    try:
        mesh = jax_make_mesh(data, 1, devices=jax.devices()[:world], batch_size=batch, pipe=pipe)
        x = shard_batch({"x": np.zeros((batch, 2, 4), np.float32)}, mesh)["x"]
        params = {"w": np.zeros((layers, 4, 4), np.float32),
                  "b": np.zeros((layers, 4), np.float32)}
        jax.eval_shape(lambda p, x_: jax_pipeline_layers(
            jax_toy_layer, p, x_, np.zeros((batch, 2), bool), mesh, n_stages=pipe,
            n_micro=micro), params, x)
        return True
    except (AssertionError, ValueError):
        return False


def _port_accepts(batch, data, pipe, micro, layers, world, monkeypatch) -> bool:
    """Whether the port's training checks take it on ``world`` ranks: the
    static keys, the mesh over the world and the row blocks."""
    cfg = training_config_from_dict(_cfg(batch_size=batch, mesh_data=data, mesh_pipe=pipe,
                                         pipeline_microbatches=micro, layers=layers))
    monkeypatch.setattr(multihost, "process_count", lambda: world)
    try:
        port_train.check_mesh_keys(cfg)
        d, m, p = mesh_lib.mesh_shape(data, 1, pipe, batch, world)
        multihost.check_mesh_alignment(mesh_lib.Mesh(data=d, model=m, pipe=p), batch)
        return True
    except ValueError:
        return False


@pytest.mark.parametrize("pipe", [2, 4])
def test_accepts_and_refuses_what_jax_does(pipe, monkeypatch):
    """The ``(batch, mesh_data, mesh_pipe, pipeline_microbatches, layers)``
    grid, on a world that the mesh fills and on one process."""
    seen = set()
    for batch in (4, 6, 8):
        for data in (1, 2):
            for micro in (0, 2, 3, 4, 8):
                for layers in (2, 4, 6):
                    for world in {data * pipe, 1}:
                        args = (batch, data, pipe, micro, layers, world)
                        want = _jax_accepts(*args)
                        assert _port_accepts(*args, monkeypatch) == want, args
                        seen.add(want)
    assert seen == {True, False}


def test_mesh_coordinates_match_jax_grid():
    """Rank r sits where JAX's ``make_mesh`` puts device r."""
    for data, model, pipe in ((1, 1, 2), (2, 1, 2), (1, 2, 2), (2, 2, 2), (1, 2, 4), (4, 1, 2)):
        n = data * model * pipe
        grid = np.asarray(jax_make_mesh(data, model, devices=jax.devices()[:n], pipe=pipe)
                          .devices)
        for idx in np.ndindex(grid.shape):
            assert mesh_lib.coordinates(grid[idx].id, model, pipe) == idx


def test_pipeline_refusals_name_their_key():
    with pytest.raises(ValueError, match="layers=6 not divisible by mesh_pipe=4"):
        port_train.check_mesh_keys(training_config_from_dict(_cfg(layers=6, mesh_pipe=4)))
    with pytest.raises(ValueError, match="batch_size=8 not divisible by pipeline_microbatches=3"):
        port_train.check_mesh_keys(training_config_from_dict(
            _pipe_cfg(mesh_pipe=2, pipeline_microbatches=3)))
    with pytest.raises(ValueError, match="seq_shard and mesh_pipe"):
        port_train.check_mesh_keys(training_config_from_dict(
            _pipe_cfg(mesh_pipe=2, mesh_model=2, seq_shard=True)))
    # EAO ignores the pipe (the JAX package pipelines MCA only)
    port_train.check_mesh_keys(training_config_from_dict(_cfg(layers=3, mesh_pipe=2, **EAO_KW)))


# -- 2 and 4 ranks ----------------------------------------------------------


@pytest.mark.parametrize("stages,micro", TOY_CASES)
def test_pipeline_layers_match_jax_and_the_sequential_stack(runs, stages, micro):
    got = _load(runs, f"toy{stages}_{micro}")
    y_jax, g_jax = runs["jax_toys"][(stages, micro)]
    y_seq, g_seq = _port_sequential_toy(*runs["toy"])
    np.testing.assert_allclose(got["y"].numpy(), y_jax, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["y"].numpy(), y_seq, rtol=1e-6, atol=1e-6)
    # gradients up to ~10 in size: torch's and XLA's fp32 sums differ in order
    np.testing.assert_allclose(got["grads"].numpy(), g_jax, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["grads"].numpy(), g_seq, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mca_step_matches_jax_pipelined_step(runs, layout):
    got = _load(runs, layout)
    want, want_final = runs["jax_steps"][layout]
    assert_metrics_close(got["metrics"], want)
    assert_params_close(got["params"], want_final)


def test_fewer_rows_than_microbatches(runs):
    """``data 2 x pipe 2`` with 8 microbatches: each rank's 4 rows run as 4
    microbatches of one; the steps equal JAX's pipelined ones."""
    got = _load(runs, "dp2_pp2_m8")
    want, want_final = runs["jax_steps"]["dp2_pp2_fsdp"]
    assert_metrics_close(got["metrics"], want)
    assert_params_close(got["params"], want_final)


def test_planted_late_stage_fails(runs):
    """Stage 1 one microbatch late: the loss leaves its bound."""
    got = _load(runs, "pipe2_late")["metrics"]
    want = runs["jax_steps"]["pipe2"][0]
    gap = abs(got[0]["total_loss"] - want[0]["total_loss"]) / abs(want[0]["total_loss"])
    assert gap > 100 * RTOL, gap


def test_planted_summed_replicated_gradients_fail(runs):
    """The pool, final-norm and logit-scale gradients summed over pipe:
    grad_norm leaves its bound."""
    got = _load(runs, "pipe2_summed")["metrics"]
    want = runs["jax_steps"]["pipe2"][0]
    gap = abs(got[0]["grad_norm"] - want[0]["grad_norm"]) / want[0]["grad_norm"]
    assert gap > 100 * RTOL, gap


def test_moe_through_the_pipe_matches_jax(runs):
    """MoE (2 experts) at pipe 2: the first loss equals JAX's pipelined
    MoE forward (``tests/test_moe.py``), the steps the port's in one
    process."""
    got = _load(runs, "moe_pipe2")
    np.testing.assert_allclose(got["metrics"][0]["total_loss"], runs["moe_loss"], rtol=RTOL)
    want, want_final = runs["moe_ref"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL


def test_eao_ignores_the_pipe(runs):
    """EAO under ``mesh_pipe: 2`` runs its whole stack on each stage and
    equals one process."""
    got = _load(runs, "eao_pipe2")
    want, want_final = runs["eao_ref"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL


def test_flash_route_through_the_pipe(runs):
    """bf16 through the flash path (plain versions on the CPU) at pipe 2
    against one process, at bf16's tolerance (``tests/test_pipeline.py``'s
    2e-3)."""
    got = _load(runs, "flash_pipe2")
    want, _ = runs["flash_ref"]
    for g, w in zip(got["metrics"], want):
        np.testing.assert_allclose(g["total_loss"], w["total_loss"], rtol=2e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_rank_coordinates_match_jax_grid(runs, world):
    got = json.loads((runs["tmp"] / f"coords{world}.json").read_text())
    for key, ranks in got.items():
        data, model, pipe = map(int, key.split("x"))
        grid = np.asarray(jax_make_mesh(data, model, devices=jax.devices()[:world], pipe=pipe)
                          .devices).reshape(data, model, pipe)
        for idx in np.ndindex(grid.shape):
            assert tuple(ranks[grid[idx].id]) == idx, (key, idx)


def test_checkpoint_at_pipe_2_restarts_at_world_1(runs):
    """Epoch 0 at ``mesh_pipe: 2``, then ``restart:`` from its checkpoint in
    one process: equal to the unbroken world-1 run."""
    tmp = runs["tmp"]
    assert len(_step_losses(tmp / "w2stop")) == 3
    np.testing.assert_allclose(_step_losses(tmp / "w2stop"), _step_losses(tmp / "w1")[:3],
                               rtol=RTOL)
    np.testing.assert_allclose(_step_losses(tmp / "w1restart"), _step_losses(tmp / "w1")[3:],
                               rtol=RTOL)
    assert param_gap(_final_params(tmp / "w1restart"), _final_params(tmp / "w1")) <= RTOL


def test_train_cli_at_two_ranks_with_mesh_pipe(runs):
    tmp = runs["tmp"]
    assert len(_step_losses(tmp / "cli2")) == 6
    np.testing.assert_allclose(_step_losses(tmp / "cli2"), _step_losses(tmp / "w1"), rtol=RTOL)
    assert param_gap(_final_params(tmp / "cli2"), _final_params(tmp / "w1")) <= RTOL
