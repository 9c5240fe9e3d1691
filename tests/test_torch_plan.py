"""The port's ``tools/memory_report``, ``tools/plan_parallel`` and
``trace_dir``, on the CPU, against the JAX package's tools where their
rules agree.

``memory_report``: the state it counts is the port's parameters, buffers
and moments, and the CLI prints one JSON line whose ``backend`` is
``cpu`` (the allocator's peak is measured on the card only).
``plan_parallel``: the plans it enumerates are JAX's, less the two kinds
the port's trainer refuses; a rank's state bytes are JAX's at ``tp ==
1`` (with and without fsdp) and, at ``tp > 1``, what the port's gloo
ranks hold when built for real (through the tool's own ``--exact``
path); with JAX's hardware constants and the same activation model its
step-time estimates and ranking are JAX's; JAX's ranking claims hold
with an injected activation model.  ``trace_dir``: a short run writes a
``torch.profiler`` trace.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like as jax_make_tcga_like
from mca_tpu.data.synthetic import tiny_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.parallel import sharding as jax_sharding
from mca_tpu.tools import plan_parallel as jax_plan
from mca_tpu.train import init_state, make_optimizer
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.tools import memory_report
from mca_tpu_torch.tools import plan_parallel as port_plan
from tests.test_torch_parallel import _cfg as _parallel_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX tool's v5e constants, to hold the formulas to JAX's numbers
JAX_HARDWARE = port_plan.Hardware(peak_flops=jax_plan.PEAK_FLOPS,
                                  link_bytes_per_s=jax_plan.ICI_BYTES_PER_S,
                                  mfu=jax_plan.ASSUMED_MFU, remat_cost=jax_plan.REMAT_COST,
                                  hbm_safety=jax_plan.HBM_SAFETY)
ACT_MODELS = {False: (2.0e6, 3.0e5), True: (1.0e6, 1.2e5)}  # injected: temp = c0 + c1 * rows
MIN_SIZE = 256  # an fsdp threshold the tiny model's leaves reach


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tcga(**overrides):
    return tiny_config("tcga", batch_size=8, **overrides)


def _cmu(**overrides):
    return tiny_config("cmu", batch_size=8, **overrides)


def _key(p):
    return (p.dp, p.tp, p.pp, p.fsdp, p.grad_accum, p.remat, p.seq_shard)


def _jax_param_shapes(cfg_dict):
    jcfg = jax_config(cfg_dict)
    widths = {m: c["pad_len"] for m, c in jcfg.modality_config.items()}
    batch = JaxCollator(jcfg.modality_config.to_plain())(
        jax_make_tcga_like(8, widths=widths, p_missing=0.25, seed=0))
    model = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, 10)
    return jax.eval_shape(lambda b: init_state(model, tx, b, seed=0),
                          jax.tree.map(jnp.asarray, batch))


def _rank_env():
    return {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
            "OMP_NUM_THREADS": "1"}


# -- memory_report ----------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["fp32", "bf16"])
def test_memory_report_counts_the_ports_state(moment_dtype):
    """On the CPU: ``state_bytes`` is the sum over the port's parameters,
    buffers and AdamW moments (bf16 moments at 2 bytes), the planner's
    count of the same; the allocator's fields are null."""
    cfg = training_config_from_dict(_tcga(precision="fp32", attention_impl="dense",
                                          moment_dtype=moment_dtype))
    out = memory_report.step_memory(cfg, device="cpu")
    model = port_train.build_trainer(cfg, "cpu")[0]
    n = sum(p.numel() for p in model.parameters())
    moment = 2 if moment_dtype == "bf16" else 4
    want = 4 * n + 2 * moment * n + sum(b.numel() * b.element_size() for b in model.buffers())
    assert out["state_bytes"] == want
    meta = port_plan._meta_model(cfg)
    assert out["state_bytes"] == port_plan._sharded_bytes(cfg, 1, 1, False) + \
        port_plan._buffer_bytes(meta)
    assert out["argument_size_in_bytes"] == out["state_bytes"] + out["batch_bytes"]
    assert out["backend"] == "cpu" and out["step_ms"] > 0
    assert out["temp_size_in_bytes"] is None and out["peak_estimate_bytes"] is None
    assert "no peak" in out["note"]


def test_memory_report_cli(tmp_path):
    cfg = _tcga(precision="fp32", attention_impl="dense")
    cfg["output_dir"] = str(tmp_path / "out")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg, sort_keys=False))
    out = subprocess.run([sys.executable, "-m", "mca_tpu_torch.tools.memory_report", str(path),
                          "--json", "--device", "cpu", "--grad-accum", "2"],
                         capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
                         env={**os.environ, **_rank_env()})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["backend"] == "cpu" and rec["grad_accum"] == 2 and rec["batch_size"] == 8
    assert rec["state_bytes"] > 0 and rec["temp_size_in_bytes"] is None
    assert not (tmp_path / "out").exists()  # inspection makes no output dir


def test_step_memory_refuses_a_missing_card():
    cfg = training_config_from_dict(_tcga())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory_report.step_memory(cfg)


# -- plan_parallel ------------------------------------------------------------


def _refusal_kind(config, p) -> str:
    why = port_plan.port_refusal(config, p)
    if why is None:
        return ""
    if "seq_shard and mesh_pipe" in why:
        assert p.pp > 1 and p.tp > 1
        return "seq_shard beside a pipe"
    assert "not divisible by pipeline_microbatches" in why, why
    assert p.pp > 1 and (8 // p.grad_accum) % p.pp
    return "microbatches"


@pytest.mark.parametrize("family", ["tcga", "cmu"])
@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_enumerate_plans_is_jax_less_the_refusals(family, devices):
    """The port's plans are JAX's, in JAX's order, less those its trainer
    refuses: ``seq_shard`` (every ``tp > 1`` plan) beside ``mesh_pipe >
    1``, and a pipe whose microbatches do not divide ``batch / grad_accum``."""
    d = _tcga() if family == "tcga" else _cmu()
    port_cfg = training_config_from_dict(d)
    want = jax_plan.enumerate_plans(jax_config(d), devices)
    got = port_plan.enumerate_plans(port_cfg, devices)
    kinds = {_key(p): _refusal_kind(port_cfg, p) for p in want}
    assert [_key(p) for p in got] == [k for k in map(_key, want) if not kinds[k]]
    if devices > 1:  # a refusal of each kind shows: pipe 2 at grad_accum 8 on 2 devices
        want_kinds = {2: {"microbatches"}, 4: {"seq_shard beside a pipe"},
                      8: {"seq_shard beside a pipe"}}[devices]
        assert set(kinds.values()) == {""} | want_kinds


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("fsdp", [False, True])
def test_sharded_bytes_match_jax_at_tp_1(dp, fsdp, monkeypatch):
    """At ``tp == 1`` a rank's parameters and two fp32 moments are three
    times JAX's parameter bytes under JAX's rules, at a threshold of
    :data:`MIN_SIZE` (no leaf of the tiny TCGA model reaches
    ``FSDP_MIN_SIZE``; each one above ``MIN_SIZE`` has a dimension ``dp``
    divides)."""
    d = _tcga(fuse_optimizer=False)
    shapes = _jax_param_shapes(d)["params"]
    monkeypatch.setattr(jax_sharding, "FSDP_MIN_SIZE", MIN_SIZE)  # JAX's tool reads it there
    want = 3 * jax_plan._sharded_bytes(shapes, dp, 1, fsdp)
    cfg = training_config_from_dict(d)
    got = port_plan._sharded_bytes(cfg, dp, 1, fsdp, fsdp_min_size=MIN_SIZE)
    assert got == want
    if fsdp:
        assert got < port_plan._sharded_bytes(cfg, dp, 1, False)


@pytest.mark.parametrize("plan", [
    port_plan.Plan(dp=1, tp=2, seq_shard=True),
    port_plan.Plan(dp=2, tp=2, fsdp=True, seq_shard=True),
    port_plan.Plan(dp=2, tp=1, fsdp=True, grad_accum=2),
], ids=["tp2", "dp2_tp2_fsdp", "dp2_fsdp_accum"])
def test_sharded_bytes_are_what_the_ranks_hold(plan):
    """The plan's state bytes against what each of its gloo ranks, built
    for real by ``exact_plan_memory`` (one ``memory_report`` step a rank),
    holds: parameters or slices, buffers and moments; the parallel tests'
    width, at which the feed-forward's ``w_in`` passes ``FSDP_MIN_SIZE``."""
    d = _parallel_cfg(attention_impl="dense")
    cfg = training_config_from_dict(d)
    reports = port_plan.exact_plan_memory(cfg, plan, device="cpu", timeout=240)
    assert len(reports) == plan.dp * plan.tp
    want = port_plan._sharded_bytes(cfg, plan.dp, plan.tp, plan.fsdp) + \
        port_plan._buffer_bytes(port_plan._meta_model(cfg))
    for r in reports:
        assert r["backend"] == "cpu" and r["dist_backend"] == "gloo"
        assert r["state_bytes"] == want, (r, want)
    if plan.tp > 1:  # the GEGLU stays whole: less than halved, unlike JAX's rules
        shapes = _jax_param_shapes(d)["params"]
        assert want > 3 * jax_plan._sharded_bytes(shapes, plan.dp, plan.tp, plan.fsdp)


def _scored(d, devices, hardware, hbm_gb=64.0):
    """JAX's and the port's scored plans (the port's set) with the same
    activation model, batch bytes and FLOPs."""
    jcfg, pcfg = jax_config(d), training_config_from_dict(d)
    shapes = _jax_param_shapes(d)
    flops = port_plan.flops_per_step(pcfg)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes["params"]))
    facts = jax_plan._model_facts(jcfg)
    assert flops == 6.0 * n_jax * facts["tokens_per_sample"] * facts["batch"]
    keep = {_key(p) for p in port_plan.enumerate_plans(pcfg, devices)}
    jax_plans = [p for p in jax_plan.enumerate_plans(jcfg, devices) if _key(p) in keep]
    kw = dict(hbm_bytes=hbm_gb * 2**30, act_models=ACT_MODELS, batch_bytes_full=4096,
              flops_per_step=flops)
    want = jax_plan.score_plans(jax_plans, jcfg, state_shapes=shapes, **kw)
    got = port_plan.score_plans(port_plan.enumerate_plans(pcfg, devices), pcfg,
                                hardware=hardware, **kw)
    return want, got


@pytest.mark.parametrize("devices", [4, 8])
def test_score_plans_with_jax_constants_is_jax(devices):
    """With JAX's v5e constants and the same activation model, every
    plan's estimated step time is JAX's, and so is the ranking."""
    want, got = _scored(_tcga(fuse_optimizer=False), devices, JAX_HARDWARE)
    est = {_key(p): p.est_step_ms for p in want}
    for p in got:
        assert p.est_step_ms == pytest.approx(est[_key(p)], rel=1e-12), _key(p)
    assert [_key(p) for p in got] == [_key(p) for p in want]


def test_plan_ranking_and_fit():
    """JAX's ``test_plan_ranking_and_fit`` claims, with an injected
    activation model and the H100's constants: a generous budget makes
    plain DP-8 the winner; a tiny one fits nothing."""
    cfg = training_config_from_dict(_tcga())
    plans = port_plan.plan(cfg, 8, hbm_gb=64.0, topk=3, act_models=ACT_MODELS, device="cpu")
    best = plans[0]
    assert best.fits and not best.remat and best.grad_accum == 1 and best.est_step_ms > 0
    stanza = best.config_stanza()
    assert stanza["mesh_data"] * stanza["mesh_model"] * stanza.get("mesh_pipe", 1) == 8
    starved = port_plan.plan(cfg, 8, hbm_gb=1e-4, topk=3, act_models=ACT_MODELS, device="cpu")
    assert not any(p.fits for p in starved)


def test_plan_on_the_cpu_needs_an_activation_model():
    cfg = training_config_from_dict(_tcga())
    with pytest.raises(RuntimeError, match="on the card"):
        port_plan.plan(cfg, 2, device="cpu")
    with pytest.raises(ValueError, match="dp / tp / fsdp"):
        port_plan.exact_plan_memory(cfg, port_plan.Plan(dp=1, tp=1, pp=2), device="cpu")


def test_activation_readings_cover_the_fewest_rows(monkeypatch):
    """The activation line is read at the fewest rows any enumerated plan
    gives a microbatch (here 1: data 2 x grad_accum 4 of a batch of 8)
    and at the batch, so no plan reads it below its readings; the
    accumulation term at grad_accum 2 over the fewest rows.  ``plan``
    without act_models asks ``fresh_step_memory`` for exactly those steps
    (faked here: the CPU keeps no allocator peak)."""
    cfg = training_config_from_dict(_tcga())
    plans = port_plan.enumerate_plans(cfg, 2)
    lo, hi = port_plan.probe_rows(cfg, plans)
    rows = [8 // (p.dp * p.grad_accum) for p in plans]
    assert (lo, hi) == (min(rows), 8) == (1, 8)
    assert min(rows) < 8 // 4  # the old readings (rows 2 and 8) lay above it
    asked = []

    def fake_step(config, grad_accum=1, remat=False, device="cuda"):
        asked.append((int(config.batch_size), grad_accum, remat))
        n = int(config.batch_size) // grad_accum
        peak = 1000 + 300 * n + (70 if grad_accum > 1 else 0) + (0 if not remat else -5 * n)
        return {"peak_estimate_bytes": peak + 40, "state_bytes": 30, "batch_bytes": 10}

    monkeypatch.setattr(port_plan, "fresh_step_memory", fake_step)
    c0, c1, accum = port_plan.fit_activation_model(cfg, False, (lo, hi), device="cuda")
    assert asked == [(1, 1, False), (8, 1, False), (2, 2, False)]
    assert (c0, c1, accum) == (1000.0, 300.0, 70.0)
    asked.clear()
    got = port_plan.plan(cfg, 2, device="cuda")
    assert sorted(asked) == sorted([(1, 1, r) for r in (False, True)] + [(8, 1, r) for r in (
        False, True)] + [(2, 2, r) for r in (False, True)])
    for p in got:
        r = 8 // (p.dp * p.grad_accum)
        if not p.remat and p.pp == 1 and p.tp == 1:
            assert p.act_bytes == 1000 + 300 * r + (70 if p.grad_accum > 1 else 0), p


def test_fresh_step_memory_is_memory_report_in_its_own_process(monkeypatch):
    """A reading is ``memory_report``'s step in a process of its own, on
    the config's rows, ``grad_accum`` and ``remat``, out of any rank
    environment the caller has (here a coordinator that is not there):
    its state and batch bytes are those of ``step_memory`` in this
    process (the CPU: no peak)."""
    for key, value in (("MCA_COORDINATOR", "localhost:9"), ("MCA_NUM_PROCESSES", "2"),
                       ("MCA_PROCESS_ID", "1")):
        monkeypatch.setenv(key, value)
    cfg = training_config_from_dict(_tcga())
    cfg.batch_size = 4
    got = port_plan.fresh_step_memory(cfg, grad_accum=2, remat=True, device="cpu",
                                      timeout=300)
    want = memory_report.step_memory(cfg, grad_accum=2, remat=True, device="cpu")
    for key in ("state_bytes", "state_tensors", "batch_bytes", "argument_size_in_bytes"):
        assert got[key] == want[key], key
    assert (got["batch_size"], got["grad_accum"], got["peak_estimate_bytes"]) == (4, 2, None)


def test_readings_run_jobs_at_a_time(monkeypatch):
    """``fit_activation_models`` runs its six readings ``jobs`` processes
    at a time, and the model does not depend on ``jobs``."""
    import threading
    import time

    cfg = training_config_from_dict(_tcga())
    lock, live, most = threading.Lock(), [0], [0]

    def fake_step(config, grad_accum=1, remat=False, device="cuda"):
        with lock:
            live[0] += 1
            most[0] = max(most[0], live[0])
        time.sleep(0.3)
        with lock:
            live[0] -= 1
        n = int(config.batch_size) // grad_accum
        peak = 1000 + 300 * n + (70 if grad_accum > 1 else 0) - (5 * n if remat else 0)
        return {"peak_estimate_bytes": peak + 40, "state_bytes": 30, "batch_bytes": 10}

    monkeypatch.setattr(port_plan, "fresh_step_memory", fake_step)
    models = {}
    for jobs in (1, 3, 6):
        most[0] = 0
        models[jobs] = port_plan.fit_activation_models(cfg, (1, 8), jobs=jobs)
        assert most[0] == jobs
    assert models[1] == models[3] == models[6] == {False: (1000.0, 300.0, 70.0),
                                                   True: (1000.0, 295.0, 70.0)}


def test_accumulation_term_only_under_grad_accum():
    """``(c0, c1, accum)`` adds ``accum`` to the activations of a plan
    with grad_accum > 1 and to no other; the step-time estimates do not
    move."""
    cfg = training_config_from_dict(_tcga())
    kw = dict(hbm_bytes=64 * 2**30, batch_bytes_full=4096, flops_per_step=1e12)
    base = port_plan.score_plans(port_plan.enumerate_plans(cfg, 4), cfg,
                                 act_models=ACT_MODELS, **kw)
    extra = {r: (*m, 5.0e5) for r, m in ACT_MODELS.items()}
    got = port_plan.score_plans(port_plan.enumerate_plans(cfg, 4), cfg, act_models=extra, **kw)
    want = {_key(p): p for p in base}
    assert any(p.grad_accum > 1 for p in got) and any(p.grad_accum == 1 for p in got)
    for p in got:
        w = want[_key(p)]
        assert p.act_bytes - w.act_bytes == (int(5.0e5) if p.grad_accum > 1 else 0), _key(p)
        assert p.est_step_ms == w.est_step_ms


def test_h100_hardware_model():
    """The default figures are the H100's, none the v5e's."""
    hw = port_plan.H100
    assert (hw.peak_flops, hw.link_bytes_per_s) == (989e12, 450e9)
    assert hw.peak_flops != jax_plan.PEAK_FLOPS and hw.link_bytes_per_s != jax_plan.ICI_BYTES_PER_S
    assert 0 < hw.mfu < 1 and hw.remat_cost > 1


# -- trace_dir ----------------------------------------------------------------


def test_trace_dir_writes_a_profiler_trace(tmp_path):
    """``trace_dir`` is no longer refused: a 2-step run on the CPU writes
    the second step's Chrome trace."""
    d = _tcga(attention_impl="pallas", epochs=1, seed=0, output_dir=str(tmp_path / "out"),
              trace_dir=str(tmp_path / "trace"), split=0.2, run_eval_loop=False)
    cfg = training_config_from_dict(d)
    port_train.check_training_keys(cfg)
    port_train.train(cfg, "cpu", rows=port_train.synthetic_rows(cfg, 20, seed=0))
    files = sorted(os.listdir(tmp_path / "trace"))
    assert files == ["step2.rank0.json"]
    with open(tmp_path / "trace" / files[0]) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("Optimizer.step" in n for n in names)  # the traced step's optimizer
