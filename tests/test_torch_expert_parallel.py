"""The port's expert parallelism (``moe_experts`` under ``mesh_model > 1``)
against the JAX package, on the CPU at 2 and 4 gloo ranks.

The tiny model of ``tests/test_torch_parallel.py`` (depth 2, dim 64, 4
heads x 16, fp32, dense attention, dropout 0) with an expert-choice MoE
in every block, initialised in JAX and carried into the port, takes
three steps on the same numpy batches.  ``data 2 x model 2`` with 4
experts is held to JAX's single-device step and to JAX's own step on a
2 x 2 mesh of forced host devices, whose rules put the expert dim on
``model`` (``tests/test_moe.py``'s expert-parallel test); 2 experts at
``model 2``, with and without ``seq_shard``, to JAX's single-device
step; 3 experts at ``model 2`` (the experts stay replicated, as JAX's
divisibility rule leaves them) and EAO with 2 experts at ``model 2`` to
the port in one process.  The expert-dim layout is held to JAX's
``param_shardings``; two planted faults must leave their bounds; a
checkpoint at ``model 2`` restarts at world 1, and world 1's at world 4.

The JAX references are computed in this process while the ranks run
(``parallel.launch``, a ``file://`` rendezvous in ``tmp_path``, a hard
timeout).
"""

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
from mca_tpu.parallel.mesh import shard_batch
from mca_tpu.parallel.sharding import param_shardings, shard_params
from mca_tpu.train import hf_lr_schedule, init_state, make_optimizer, make_train_step
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.parallel import sharding
from mca_tpu_torch import train as port_train
from tests.test_torch_parallel import (EAO_KW, RTOL, RUN_ROWS, STEPS, _batches, _cfg,
                                       _final_params, _jax_steps, _launch, _port_steps,
                                       _run_cfg, _step_losses, _train_here, assert_metrics_close,
                                       one_torch_thread, param_gap)  # noqa: F401 (autouse)

MOE_CF = 2.0

RANK_SCRIPT = r'''
import json, sys
import numpy as np, torch
torch.set_num_threads(1)
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.models.moe import MoEFeedForward
from mca_tpu_torch.parallel.multihost import init_multihost, is_primary, make_stager


class StopRun(Exception):
    pass


def first_experts(model, opt):
    """Every rank computes the experts of model rank 0's range."""
    for mod in model.modules():
        if isinstance(mod, MoEFeedForward):
            n = mod.experts["w_in"].shape[0]
            mod.local_experts = lambda n=n: (0, n)


def router_not_summed(model, opt):
    """The router's gradient left as each rank's partial sum."""
    opt.model_partial = [s and not n.endswith("router.weight")
                         for n, s in zip(opt.names, opt.model_partial)]


def steps(job):
    cfg = training_config_from_dict(job["config"])
    inputs = torch.load(job["inputs"], weights_only=False)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=job["total"],
                                                 params=inputs["params"] if job["jax_weights"]
                                                 else None)
    if job.get("fault"):
        globals()[job["fault"]](model, opt)
    shapes = {n: list(p.shape) for n, p in model.named_parameters() if ".ff." in n}
    stage = make_stager(opt.mesh, int(cfg.batch_size))
    hist = [port_train.train_step(model, opt, sched, port_train.to_device(stage(b), "cpu"),
                                  clip=float(cfg.clip))
            for b in inputs["batches"]]
    whole = opt.model_state_dict()
    moments = opt.state_dict()
    if is_primary():
        torch.save({"metrics": hist, "params": whole, "optimizer": moments, "shapes": shapes},
                   job["out"])


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


def _moe_cfg(experts, **overrides):
    return _cfg(moe_experts=experts, moe_capacity_factor=MOE_CF, **overrides)


def _jax_ep_steps(cfg_dict, batches, params0):
    """JAX's own step on a 2 x 2 ('data', 'model') mesh of host devices,
    the parameters placed by its rules (the expert dim over 'model')."""
    jcfg = jax_config(cfg_dict)
    mesh = jax_make_mesh(2, 2, devices=jax.devices()[:4])
    model = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS)
    params = shard_params(jax.tree.map(jnp.asarray, params0), mesh)
    state = {"params": params, "opt_state": tx.init(params), "step": jnp.zeros((), jnp.int32)}
    step = make_train_step(model, tx, schedule)
    hist = []
    for b in batches:
        state, m = step(state, shard_batch(b, mesh))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, jax.tree.map(np.asarray, jax.device_get(state["params"]))


def _jax_init(cfg_dict, batch):
    """The initial parameters of :func:`_jax_steps` (``init_state``, seed 0)."""
    jcfg = jax_config(cfg_dict)
    model = jax_build_model(jax_model_config(jcfg))
    state = init_state(model, make_optimizer(jcfg, num_training_steps=STEPS),
                       jax.tree.map(jnp.asarray, batch), seed=0)
    return jax.tree.map(np.array, state["params"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One launch at 2 ranks and one at 4, in threads while this process
    computes the JAX references and the world-1 runs, then the world-1
    restart of the world-2 checkpoint."""
    tmp = tmp_path_factory.mktemp("expert_parallel")
    batches = _batches()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")
        p2, p4 = (_jax_init(_moe_cfg(e), batches[0]) for e in (2, 4))
    for e, p in ((2, p2), (4, p4)):
        torch.save({"params": state_dict_from_jax_params(p), "batches": batches},
                   tmp / f"inputs{e}.pt")
    # world 1 first: its epoch-0 checkpoint is world 4's restart
    _train_here(_run_cfg(tmp / "w1", **_moe_kw(2)))
    _train_here(_run_cfg(tmp / "w1stop", **_moe_kw(2)), stop_after_eval=True)

    def steps(name, experts, jax_weights=True, **overrides):
        # the batches, and JAX's weights where the run takes them
        inputs = tmp / f"inputs{experts if jax_weights else 2}.pt"
        return {"kind": "steps", "config": _moe_cfg(experts, **overrides),
                "inputs": str(inputs), "total": STEPS,
                "out": str(tmp / f"{name}.pt"), "jax_weights": jax_weights}

    jobs2 = [steps("e2_tp2", 2, mesh_model=2),
             steps("e2_tp2_seq", 2, mesh_model=2, seq_shard=True),
             steps("e2_tp2+first_experts", 2, mesh_model=2) | {"fault": "first_experts"},
             steps("e2_tp2+router_not_summed", 2, mesh_model=2) | {"fault": "router_not_summed"},
             steps("e3_tp2", 3, jax_weights=False, mesh_model=2),
             steps("e3_tp2_seq", 3, jax_weights=False, mesh_model=2, seq_shard=True),
             steps("eao_e2_tp2", 2, jax_weights=False, mesh_model=2, attention_impl="pallas",
                   **EAO_KW),
             {"kind": "train", "config": _run_cfg(tmp / "w2stop", mesh_model=2, **_moe_kw(2)),
              "rows": RUN_ROWS, "stop_after_eval": True}]
    jobs4 = [steps("e4_dp2_tp2", 4, mesh_data=2, mesh_model=2),
             steps("e4_dp2_tp2_fsdp_seq", 4, mesh_data=2, mesh_model=2, fsdp=True,
                   seq_shard=True),
             {"kind": "train", "config": _run_cfg(tmp / "w4restart", mesh_data=2, mesh_model=2,
                                                  restart=str(tmp / "w1stop" / "0"),
                                                  **_moe_kw(2)),
              "rows": RUN_ROWS}]
    with ThreadPoolExecutor(2) as pool:
        launches = [pool.submit(_launch, tmp, 2, jobs2, RANK_SCRIPT),
                    pool.submit(_launch, tmp, 4, jobs4, RANK_SCRIPT)]
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("MCA_FUSED_FF", "0")
            _, ref2, ref2_final = _jax_steps(_moe_cfg(2), batches)
            _, ref4, ref4_final = _jax_steps(_moe_cfg(4), batches)
            mesh4, mesh4_final = _jax_ep_steps(_moe_cfg(4), batches, p4)
        e3_ref = _port_steps(_moe_cfg(3), batches)
        eao_ref = _port_steps(_moe_cfg(2, attention_impl="pallas", **EAO_KW), batches)
        for f in launches:
            f.result()
    _train_here(_run_cfg(tmp / "w1restart", restart=str(tmp / "w2stop" / "0"), **_moe_kw(2)))
    return {"tmp": tmp, "init2": state_dict_from_jax_params(p2),
            "ref2": (ref2, state_dict_from_jax_params(ref2_final)),
            "ref4": (ref4, state_dict_from_jax_params(ref4_final)),
            "mesh4": (mesh4, state_dict_from_jax_params(mesh4_final)),
            "e3_ref": e3_ref, "eao_ref": eao_ref}


def _moe_kw(experts):
    return dict(moe_experts=experts, moe_capacity_factor=MOE_CF)


def _load(runs, name):
    return torch.load(runs["tmp"] / f"{name}.pt", weights_only=False)


def _update_gap(got, ref, init, keys) -> float:
    """The largest relative L2 gap between two runs' updates (final -
    initial) over ``keys``."""
    def t(x):
        return torch.as_tensor(x).float()

    return max(float((t(got[k]) - t(ref[k])).norm() / (t(ref[k]) - t(init[k])).norm())
               for k in keys)


# -- no ranks -------------------------------------------------------------


@pytest.mark.parametrize("experts", [2, 3, 4])
def test_expert_layout_matches_jax_param_shardings(experts):
    """Rank r of 2 holds experts [r E / 2, (r + 1) E / 2) where JAX's rules
    put the expert dim on 'model'; where E does not divide, both keep the
    experts whole; the router stays whole."""
    dim, inner = 8, 10
    leaves = {"w_in": np.arange(experts * dim * 2 * inner, dtype=np.float32)
              .reshape(experts, dim, 2 * inner),
              "w_out": np.arange(experts * inner * dim, dtype=np.float32)
              .reshape(experts, inner, dim),
              "router": np.ones((dim, experts), np.float32)}
    mesh = jax_make_mesh(1, 2, devices=jax.devices()[:2])
    tree = {"params": {"layer_0": {"ff": leaves}}}
    specs = param_shardings(tree, mesh)["params"]["layer_0"]["ff"]
    names = {"w_in": "layers.0.ff.experts.w_in", "w_out": "layers.0.ff.experts.w_out",
             "router": "layers.0.ff.router.weight"}
    for key, name in names.items():
        full = torch.from_numpy(leaves[key])
        parts = [sharding.tp_shard(name, full, 2, r) for r in range(2)]
        if specs[key].spec == jax.sharding.PartitionSpec("model"):
            assert [tuple(p.shape) for p in parts] == [(experts // 2,) + full.shape[1:]] * 2
            assert torch.equal(torch.cat(parts), full)
        else:
            assert specs[key].spec == jax.sharding.PartitionSpec()
            assert all(p is full for p in parts)
    assert (specs["w_in"].spec == jax.sharding.PartitionSpec("model")) == (experts % 2 == 0)


# -- 2 and 4 ranks ----------------------------------------------------------


def test_dp_ep_step_matches_jax(runs):
    """``data 2 x model 2``, 4 experts (one pair a rank): JAX's
    single-device step and JAX's own expert-parallel step."""
    got = _load(runs, "e4_dp2_tp2")
    assert got["shapes"]["layers.0.ff.experts.w_in"][0] == 2
    assert got["shapes"]["layers.0.ff.router.weight"] == [64, 4]
    for ref in ("ref4", "mesh4"):
        want, want_final = runs[ref]
        assert_metrics_close(got["metrics"], want)
        assert param_gap(got["params"], want_final) <= RTOL


def test_dp_ep_fsdp_seq_shard_matches_jax(runs):
    got = _load(runs, "e4_dp2_tp2_fsdp_seq")
    want, want_final = runs["ref4"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL


@pytest.mark.parametrize("name", ["e2_tp2", "e2_tp2_seq"])
def test_ep_step_matches_jax(runs, name):
    """2 experts at ``model 2`` (one a rank), with and without seq_shard."""
    got = _load(runs, name)
    want, want_final = runs["ref2"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL
    # the moments come back whole, in the single-process layout
    st = got["optimizer"]["state"]
    assert any(tuple(s["exp_avg"].shape) == (2, 64, 2 * 170) for s in st.values())


@pytest.mark.parametrize("name", ["e3_tp2", "e3_tp2_seq"])
def test_indivisible_experts_stay_replicated(runs, name):
    """3 experts do not split over 2 ranks: each rank holds and computes
    all three, as JAX's rule leaves them; equal to one process."""
    got = _load(runs, name)
    assert got["shapes"]["layers.0.ff.experts.w_in"][0] == 3
    want, want_final = runs["e3_ref"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL


def test_eao_with_experts_at_model_2(runs):
    got = _load(runs, "eao_e2_tp2")
    want, want_final = runs["eao_ref"]
    assert_metrics_close(got["metrics"], want)
    assert param_gap(got["params"], want_final) <= RTOL


def test_planted_first_experts_fails(runs):
    """Every rank computing model rank 0's experts: the update leaves its
    bound."""
    got = _load(runs, "e2_tp2+first_experts")["params"]
    want = runs["ref2"][1]
    keys = [k for k in want if ".ff.experts." in k]
    assert _update_gap(got, want, runs["init2"], keys) > 0.15


def test_planted_unsummed_router_fails(runs):
    """The router's gradient not summed over ``model``: the router's
    update leaves its bound."""
    got = _load(runs, "e2_tp2+router_not_summed")["params"]
    want = runs["ref2"][1]
    keys = [k for k in want if k.endswith("router.weight")]
    assert _update_gap(got, want, runs["init2"], keys) > 0.15


def test_checkpoint_at_model_2_restarts_at_world_1(runs):
    tmp = runs["tmp"]
    assert len(_step_losses(tmp / "w2stop")) == 3
    np.testing.assert_allclose(_step_losses(tmp / "w1restart"), _step_losses(tmp / "w1")[3:],
                               rtol=RTOL)
    assert param_gap(_final_params(tmp / "w1restart"), _final_params(tmp / "w1")) <= RTOL


def test_checkpoint_at_world_1_restarts_at_world_4(runs):
    """The world-1 epoch-0 checkpoint on ``data 2 x model 2`` (one expert a
    model rank)."""
    tmp = runs["tmp"]
    np.testing.assert_allclose(_step_losses(tmp / "w4restart"), _step_losses(tmp / "w1")[3:],
                               rtol=RTOL)
    assert param_gap(_final_params(tmp / "w4restart"), _final_params(tmp / "w1")) <= RTOL


def test_expert_parallel_training_keys_are_accepted():
    port_train.check_training_keys(training_config_from_dict(_moe_cfg(2, mesh_model=2)))
    port_train.check_training_keys(training_config_from_dict(
        _moe_cfg(4, mesh_data=2, mesh_model=2, fsdp=True, seq_shard=True)))
