"""The readers of the program's own spans, on the CPU at the tests' tiny
configurations: both drivers run traced in this process, every host-side
reader gives a finite number, every device-side one nothing, and the
window's selection takes exactly the window's steps and requests.

On the card both traced segments run under a profiler; a CPU rehearsal
runs the device-only one unrecorded.  These runs record it under a CPU
profiler instead, as the card would, so that the selection is the
card's."""

import gc
import math
import sys

import numpy as np
import pytest
import torch

from portbench import harness, spans
from portbench.tests.conftest import CHECKOUT, DATA

TRAIN_HOST = ("collate_ms.train", "copy_ms.train", "forward_host_ms.train",
              "backward_host_ms.train", "optimizer_host_ms.train", "readback_wait_ms.train",
              "build_s")
TRAIN_DEVICE = ("device_step_ms.train", "grad_reduce_ms.train")
SERVE_HOST = ("queue_wait_ms.serve", "service_ms.serve", "padded_row_share.serve", "build_s")
SERVE_DEVICE = ("forward_device_ms.serve",)
NEW = TRAIN_HOST + TRAIN_DEVICE + SERVE_HOST[:-1] + SERVE_DEVICE


def profiled_on_cpu(fn, device):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    return None


def traced_run(monkeypatch, workload, seed=2**31 + 91):
    bench = harness.load_json(DATA / "bench.json")
    cell = harness.find_cell(bench, workload)
    traffic = harness.load_json(DATA / "traffic" / f"{cell['traffic']}.json")
    drv = harness.driver(traffic["driver"])
    monkeypatch.setattr(drv, "device_busy", profiled_on_cpu)
    run = harness.Run(cell=cell, cfg=harness.config_of(bench, CHECKOUT, cell["config"]),
                      traffic=traffic, limits={}, seed=seed, seconds=1.0, trace=True,
                      device=torch.device("cpu"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return traffic, drv.run(run).ctx
    finally:
        torch.set_num_threads(n)
        gc.unfreeze()


def read_all(ctx, names):
    return {n: harness.reader(n)(ctx) for n in names}


@pytest.mark.parametrize("workload", ["tiny_tab.train", "tiny_seq.train"])
def test_training_readers(monkeypatch, workload):
    traffic, ctx = traced_run(monkeypatch, workload)
    got = read_all(ctx, TRAIN_HOST + TRAIN_DEVICE)
    for name in TRAIN_HOST:
        assert got[name] is not None and math.isfinite(got[name]) and got[name] >= 0, name
    assert got["forward_host_ms.train"] > 0 and got["backward_host_ms.train"] > 0
    for name in TRAIN_DEVICE:
        assert got[name] is None, name
    steps = spans.window_steps(ctx)
    n = ctx["host"]["steps"]
    first = max(int(traffic["warmup_steps"]), int(traffic["checked_steps"]))
    assert list(steps["step"]) == list(range(first, first + n))
    assert (steps["profiled"] == 0).all()
    # the traced segments' steps follow, every one of them profiled
    later = spans.recorder().records("train.step")
    later = later["profiled"][later["seq"] > steps["seq"][-1]]
    assert len(later) == 2 * ctx["host"]["traced_steps"] and later.all()


def test_serving_readers(monkeypatch):
    traffic, ctx = traced_run(monkeypatch, "tiny_tab.serve")
    got = read_all(ctx, SERVE_HOST + SERVE_DEVICE)
    for name in SERVE_HOST:
        assert got[name] is not None and math.isfinite(got[name]) and got[name] >= 0, name
    assert 0 <= got["padded_row_share.serve"] < 100
    assert got["forward_device_ms.serve"] is None
    r = spans.window_requests(ctx)
    assert len(r["id"]) == ctx["host"]["rows"] and (r["profiled"] == 0).all()
    assert (np.diff(r["id"]) == 1).all()
    assert (r["submit"] <= r["dispatch"]).all() and (r["dispatch"] <= r["answer"]).all()
    b = spans.window_batches(ctx)
    # the window's forwards carried the window's requests and no others
    assert spans.counted("serve.rows", b["seq"]) == ctx["host"]["rows"]
    padded = spans.counted("serve.padded_rows", b["seq"])
    assert ctx["host"]["rows"] + padded == len(b["seq"]) * int(traffic["max_batch"])


def test_readers_read_nothing_without_the_recorder(monkeypatch):
    """On a checkout from before the program's recorder, every new reader
    returns None and raises nothing."""
    monkeypatch.setitem(sys.modules, "mca_tpu_torch.utils.trace", None)
    assert spans.recorder() is None
    ctx = {"device_type": "cuda", "host": {"steps": 3, "rows": 10, "traced_steps": 2}}
    assert read_all(ctx, NEW) == {n: None for n in NEW}
