"""The runner end to end on the CPU at tiny sizes, from the
configuration and traffic files in ``data/``: both drivers, untraced and
traced, the result line's keys, the two-rank gloo launch, and the runs
that must print no result."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench.tests.conftest import CHECKOUT, DATA

RUN = CHECKOUT / "portbench" / "run.py"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(workload, trace=0, seed=2**31 + 77, cwd=CHECKOUT, device="cpu", run=RUN):
    argv = [sys.executable, str(run), "--workload", workload, "--seed", str(seed),
            "--seconds", "1", "--trace", str(trace), "--bench", str(DATA / "bench.json"),
            "--data", str(DATA)]
    if device:
        argv += ["--device", device]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(argv, cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def result(p):
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    return line


@pytest.mark.parametrize("workload,trace", [
    ("tiny_tab.train", 0), ("tiny_tab.train", 1), ("tiny_seq.train", 0),
    ("tiny_tab.serve", 0), ("tiny_tab.serve", 1),
])
def test_a_run_prints_its_line(workload, trace):
    p = run_cell(workload, trace)
    line = result(p)
    keys = KEYS + (["breakdown"] if "breakdown" in line else []) + ["checks"]
    assert list(line) == keys
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    bench = json.loads((DATA / "bench.json").read_text())
    e2e = [m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in bench["per_layer"]}
        assert line["metrics"], "a traced run reads some per-layer metric"
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert sorted(line["metrics"]) == sorted(e2e)
    for name, c in line["checks"].items():
        assert f"check {name} {c['value']!r} limit {c['limit']!r}" in p.stderr
    assert p.stderr.rstrip().splitlines()[-1].startswith("check ")


def test_two_ranks_over_gloo():
    line = result(run_cell("tiny_tab.train.dp2"))
    assert line["correct"] is True and line["device"]["count"] == 2
    assert line["metrics"]["train_tokens_per_s"]["value"] > 0


def test_no_card_no_result():
    p = run_cell("tiny_tab.train", device=None)
    assert p.returncode != 0 and not p.stdout.strip()


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copytree(CHECKOUT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = run_cell("tiny_tab.train", cwd=tmp_path, run=tmp_path / "portbench" / "run.py")
    assert p.returncode != 0 and not p.stdout.strip()
