"""The control at a size a test run holds: the reference with float8
products in the program's place, read against the fp32 reference, must
fail the cell's limits that the program's own bf16 readings pass, in
training and in serving.  ``portbench/tools/control.py`` makes the
readings at the cells' sizes and judges each by the cell's limits: on
the CPU against the tests' limits, and on the card (``card``) against
the committed ones.  The round-off witnesses and the load generator's
lateness tool run here too, at tiny sizes."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from portbench import check
from portbench.data import make_rows, make_weights
from portbench.reference import train as rt
from portbench.reference.model import Reference
from portbench.tests.conftest import CHECKOUT, DATA, tiny_config

SEEDS = [2**31 + 1, 2**31 + 2, 2**31 + 3]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["tiny_tab", "tiny_seq"])
def test_fp8_reference_fails_the_training_limits(name, seed):
    cfg = tiny_config(name)
    limits = json.loads((DATA / "limits" / f"{name}.train.json").read_text())
    rows = make_rows(cfg, 24, seed, 0.25)
    params = make_weights(cfg, seed, "cpu")
    batches = [rows[i * 8:(i + 1) * 8] for i in range(3)]
    ref = rt.train_steps(cfg, params, batches, 1000, 4, "cpu")
    ctrl = rt.train_steps(cfg, params, batches, 1000, 4, "cpu", precision="fp8")
    numbers = check.with_limits(check.train_numbers(ctrl, ref), limits)
    assert any(v > lim for _, v, lim in numbers), numbers


@pytest.mark.parametrize("seed", SEEDS)
def test_fp8_reference_fails_the_serving_limits(seed):
    cfg = tiny_config("tiny_tab")
    limits = json.loads((DATA / "limits" / "tiny_tab.serve.json").read_text())
    rows = make_rows(cfg, 8, seed, 0.25)
    params = make_weights(cfg, seed, "cpu")
    ref, ctrl = Reference(cfg), Reference(cfg, "fp8")
    pooled, present = rt.pooled_all(ref, params, rows, 4, "cpu")
    emb = {k: v.numpy() for k, v in ref.embeddings(pooled).items()}
    cp, cpres = rt.pooled_all(ctrl, params, rows, 4, "cpu")
    answers = [{"embeddings": {k: v[i].numpy() for k, v in ctrl.embeddings(cp).items()},
                "present": {m: bool(v[i]) for m, v in cpres.items()}} for i in range(len(rows))]
    numbers = check.with_limits(
        check.serve_numbers(answers, emb, {m: p.numpy() for m, p in present.items()}), limits)
    assert any(v > lim for _, v, lim in numbers), numbers
    assert np.isfinite([v for _, v, _ in numbers]).all()


TOOLS = CHECKOUT / "portbench" / "tools"


def tool(name, *argv, data=DATA, device="cpu", timeout=600):
    cmd = [sys.executable, str(TOOLS / name), *argv, "--device", device]
    env = dict(os.environ)
    if device == "cpu":
        cmd += ["--bench", str(DATA / "bench.json"), "--data", str(data)]
        env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(cmd, cwd=CHECKOUT, capture_output=True, text=True, timeout=timeout,
                          env=env)


def readings(p):
    return [json.loads(x) for x in p.stdout.splitlines() if x.startswith('{"kind"')]


@pytest.mark.parametrize("workload,extra", [("tiny_tab.train", ["--fault-seeds", str(SEEDS[0])]),
                                            ("tiny_tab.serve", [])])
def test_the_control_tool_judges_each_reading_by_the_cells_limits(workload, extra):
    seed = str(SEEDS[0])
    p = tool("control.py", "--workload", workload, "--seeds", seed, "--control-seeds", seed,
             "--seconds", "1", *extra)
    assert p.returncode == 0, p.stderr[-3000:]
    verdicts = {r["kind"]: r["correct"] for r in readings(p)}
    assert verdicts.pop("program") is True
    assert verdicts and not any(verdicts.values()), verdicts  # the control, and the fault


def test_the_control_tool_fails_where_the_control_passes(tmp_path):
    shutil.copytree(DATA / "traffic", tmp_path / "traffic")
    (tmp_path / "limits").mkdir()
    (tmp_path / "limits" / "tiny_tab.serve.json").write_text('{"emb_gap": 1e9, "mask_errors": 1e9}')
    seed = str(SEEDS[0])
    p = tool("control.py", "--workload", "tiny_tab.serve", "--seeds", seed,
             "--control-seeds", seed, "--seconds", "1", data=tmp_path)
    assert p.returncode == 1, p.stderr[-3000:]
    assert {r["kind"]: r["correct"] for r in readings(p)} == {"program": True, "control": True}


def test_the_round_off_witnesses_read_every_pair():
    p = tool("round_off.py", "--workload", "tiny_tab.train", "--seeds", str(SEEDS[1]), "--look")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    pairs, (look,) = lines[:-1], lines[-1:]
    assert [x["pair"].split(" vs ")[0] for x in pairs] == [
        "program (fused)", "program (split)", "program (split)", "bf16 reference"]
    assert all(len(x["loss_gaps"]) == 3 and np.isfinite(x["grad_gap"]) for x in pairs)
    steps = look["each_step_from_the_programs_state"]
    assert [s["step"] for s in steps] == [1, 2, 3]
    assert steps[0]["loss_gap"] == pytest.approx(pairs[0]["loss_gaps"][0])  # the same first step
    assert all(s["program_gradient"]["worst"][1] < 0.1 for s in steps)


def test_the_generator_alone_sends_on_time():
    p = tool("generator_lateness.py", "--workload", "tiny_tab.serve", "--seconds", "2")
    assert p.returncode == 0, p.stderr[-3000:]
    (line,) = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
    assert line["requests"] == 80 and line["failed"] == 0
    assert 0 <= line["late_p50_ms"] <= line["late_p95_ms"] <= line["late_max_ms"]


@pytest.mark.card
@pytest.mark.parametrize("workload,extra", [
    ("tcga_mca.train.b64", ["--fault-seeds", "2147483711"]),
    ("cmu_mca.train.b64", []),
    ("tcga_mca.serve.poisson_b32", []),
])
def test_the_control_fails_the_committed_limits(card, workload, extra):
    """At the cell's own size, against ``portbench/limits/<cell>.json``."""
    p = tool("control.py", "--workload", workload, "--seeds", "2147483711",
             "--control-seeds", "2147483711", *extra, device="cuda", timeout=1200)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    verdicts = {r["kind"]: r["correct"] for r in readings(p)}
    assert verdicts.pop("program") is True and not any(verdicts.values()), verdicts
