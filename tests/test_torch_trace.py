"""The port's recorder (``mca_tpu_torch/utils/trace.py``): spans, counts
and request records in bounded int64 columns, the profiled flag and the
``mca.*`` ranges a profiler sees, the clock shared with kineto, device
timings read only once complete, ``trace_context``, and the spans the
training step, the loader, the build and the service record."""

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mca_tpu.data.synthetic import tiny_config
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.dataset import BatchedLoader
from mca_tpu_torch.serve import EmbeddingService
from mca_tpu_torch.utils import logging as port_logging
from mca_tpu_torch.utils import trace

STEP_SPANS = ("train.forward", "train.backward", "train.optimizer", "train.readback")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes (the suite's workers
    share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(**overrides):
    return training_config_from_dict(tiny_config("tcga", batch_size=4, **overrides))


def test_spans_nest_with_their_parents_and_ordinals():
    rec = trace.Recorder(64)
    with rec.span("outer", step=7) as outer:
        with rec.span("inner", step=7, micro=1) as inner:
            rec.count("things", 3)
        with rec.span("other"):
            pass
    with pytest.raises(ValueError, match="two ordinals"):
        rec.span("x", a=1, b=2, c=3)
    t = rec.records()
    assert list(t["name"]) == ["outer", "inner", "things", "other"]
    assert list(t["parent"]) == [-1, outer.seq, inner.seq, outer.seq]
    assert list(t["step"]) == [7, 7, -1, -1] and list(t["micro"]) == [-1, 1, -1, -1]
    assert list(t["value"]) == [-1, -1, 3, -1]
    assert t["start"][0] <= t["start"][1] <= t["end"][1] <= t["end"][0]
    assert t["start"][2] == t["end"][2]  # a count is an instant
    assert (t["profiled"] == 0).all()
    assert list(rec.records("inner")["seq"]) == [inner.seq]
    assert list(rec.records(prefix="o")["name"]) == ["outer", "other"]


def test_the_buffer_wraps_at_its_bound():
    rec = trace.Recorder(8)
    with pytest.raises(ValueError, match="power of two"):
        trace.Recorder(12)
    with rec.span("long") as long:
        for i in range(20):
            with rec.span("short", step=i):
                pass
    # the open span's slot was taken by a newer record: its end goes nowhere
    t = rec.records()
    assert len(t["seq"]) == 8 and list(t["seq"]) == list(range(13, 21))
    assert list(t["step"]) == list(range(12, 20)) and long.seq not in t["seq"]
    assert (t["end"] >= t["start"]).all()
    assert rec._rows.shape == (8, len(trace.FIELDS)) and rec._rows.dtype == np.int64
    assert len(rec.records(since=rec.mark())["seq"]) == 0


def test_request_records_stamp_a_batch_at_once_and_wrap():
    rec = trace.Recorder(8)
    rids = [rec.request() for _ in range(12)]
    rec.dispatched(rids, 41)  # the first four were overwritten by the last four
    rec.answered(rids[-3:])
    rec.dispatched([], 42)
    r = rec.requests()
    assert list(r["id"]) == rids[4:] and (r["batch"] == 41).all()
    assert len(set(r["dispatch"])) == 1 and (r["dispatch"] >= r["submit"]).all()
    assert (r["answer"][:-3] == 0).all() and (r["answer"][-3:] >= r["dispatch"][-3:]).all()
    assert rec.request_mark() == 12


def test_the_profiled_flag_and_record_function_only_under_a_profiler(monkeypatch):
    entered = []
    real = torch.profiler.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    rec = trace.Recorder(64)
    with rec.span("quiet"):
        rid = rec.request()
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("loud"):
            rec.count("n", 1)
            loud_rid = rec.request()
    assert entered == ["mca.loud"]
    t = rec.records()
    assert dict(zip(t["name"], t["profiled"])) == {"quiet": 0, "loud": 1, "n": 1}
    r = rec.requests()
    assert dict(zip(r["id"], r["profiled"])) == {rid: 0, loud_rid: 1}
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "mca.loud" in names and "mca.quiet" not in names


def test_spans_share_the_profiler_clock():
    rec = trace.Recorder(64)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with rec.span("tick", step=i):
                torch.ones(64).sum()
            time.sleep(0.002)
    offsets = trace.kineto_offsets(prof.profiler.kineto_results.events(), rec.records())
    assert len(offsets) == 5 and {n for n, _ in offsets} == {"tick"}
    assert max(abs(d) for _, d in offsets) < 1_000_000  # ns


class _Event:
    """A stand-in CUDA event pair member: done once ``done`` is set."""

    def __init__(self, t_ms):
        self.t_ms, self.done = t_ms, False

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert end.done, "read before the end event completed"
        return end.t_ms - self.t_ms


def test_device_times_are_read_only_once_complete():
    rec = trace.Recorder(64)
    with rec.span("cpu") as sp:
        sp.device_start("cpu")  # no event off a CUDA device
        sp.device_end()
    assert not rec._pending
    spans = []
    for i in range(2):
        with rec.span("timed") as sp:
            pass
        start, end = _Event(0.0), _Event(1.5 + i)
        start.done = True
        rec._await(sp.seq, start, end)
        spans.append(end)
    rec.settle()
    assert list(rec.records("timed")["value"]) == [-1, -1]
    spans[0].done = True
    rec.settle()
    assert list(rec.records("timed")["value"]) == [1_500_000, -1]
    spans[1].done = True
    rec.settle()
    assert list(rec.records("timed")["value"]) == [1_500_000, 2_500_000]
    assert list(rec.records("cpu")["value"]) == [-1]


def test_threads_keep_their_own_parents():
    rec = trace.Recorder(1 << 12)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(k):
        try:
            for i in range(50):
                with rec.span("outer", worker=k, step=i) as o:
                    with rec.span("inner", worker=k, step=i):
                        rec.count("c", 1)
                    if rec._local.stack != [o.seq]:
                        errors.append((k, i))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    t = rec.records()
    assert len(t["seq"]) == 8 * 50 * 3 and len(set(t["seq"])) == len(t["seq"])
    by_seq = {s: (w, st) for s, w, st in zip(t["seq"], t["worker"], t["step"])}
    inner = t["name"] == "inner"
    assert all(by_seq[p] == (w, st)
               for p, w, st in zip(t["parent"][inner], t["worker"][inner], t["step"][inner]))
    counts = t["name"] == "c"
    assert set(t["name"][np.isin(t["seq"], t["parent"][counts])]) == {"inner"}


@pytest.mark.parametrize("n_accum", [1, 2])
def test_train_step_records_its_spans_each_step(n_accum):
    cfg = _config(grad_accum=n_accum)
    rows = port_train.synthetic_rows(cfg, 4)
    mark = trace.RECORDER.mark()
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=10)
    batch = port_train.to_device(MultimodalCollator(cfg.modality_config.to_plain())(rows), "cpu")
    for _ in range(3):
        port_train.train_step(model, opt, sched, batch, clip=1.0, n_accum=n_accum)
    t = trace.RECORDER.records(since=mark)
    steps = t["name"] == "train.step"
    assert list(t["step"][steps]) == [0, 1, 2]
    step_of = dict(zip(t["seq"][steps], t["step"][steps]))
    for name in STEP_SPANS:
        hit = t["name"] == name
        each = n_accum if name in ("train.forward", "train.backward") else 1
        assert list(t["step"][hit]) == [s for s in (0, 1, 2) for _ in range(each)], name
        assert [step_of[p] for p in t["parent"][hit]] == list(t["step"][hit]), name
        if each > 1:
            assert list(t["micro"][hit]) == [0, 1] * 3
    assert (t["value"][steps] == -1).all()  # no device time off the card
    build = trace.RECORDER.records(prefix="build.", since=mark)
    assert list(build["name"]) == ["build.model", "build.weights", "build.move",
                                   "build.optimizer"]
    assert (t["name"] == "data.copy").sum() == 1


def test_trace_context_writes_mca_ranges(tmp_path):
    assert port_logging.trace_context is trace.trace_context
    cfg = _config()
    rows = port_train.synthetic_rows(cfg, 4)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=10)
    batch = port_train.to_device(MultimodalCollator(cfg.modality_config.to_plain())(rows), "cpu")
    port_train.train_step(model, opt, sched, batch)
    with trace.trace_context(str(tmp_path), "step2"):
        port_train.train_step(model, opt, sched, batch)
    events = json.loads((tmp_path / "step2.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"mca.train.step", *(f"mca.{n}" for n in STEP_SPANS)} <= names
    with trace.trace_context("", "nothing"):
        pass
    assert not (tmp_path / "nothing.json").exists()


def test_the_loader_records_each_collation_on_its_thread():
    cfg = _config()
    rows = port_train.synthetic_rows(cfg, 12)
    mark = trace.RECORDER.mark()
    loader = BatchedLoader(rows, MultimodalCollator(cfg.modality_config.to_plain()), 4,
                           shuffle=True, prefetch=1)
    loader.set_epoch(3)
    assert len(list(loader)) == 3
    t = trace.RECORDER.records("data.collate", since=mark)
    assert list(t["batch"]) == [0, 1, 2] and list(t["epoch"]) == [3, 3, 3]
    assert (t["parent"] == -1).all()  # the prefetch thread's own stack


def test_the_service_stamps_every_request():
    cfg = _config()
    rows = port_train.synthetic_rows(cfg, 10)
    mark, rmark = trace.RECORDER.mark(), trace.RECORDER.request_mark()
    svc = EmbeddingService(cfg, max_batch=4, max_wait_ms=20, device="cpu")
    build = trace.RECORDER.records(prefix="build.", since=mark)
    assert list(build["name"]) == ["build.model", "build.weights", "build.move", "build.warmup"]
    svc.start()
    try:
        futs = [svc.submit(r) for r in rows]
        for f in futs:
            f.result(timeout=60)
    finally:
        svc.stop()
    r = trace.RECORDER.requests(since=rmark)
    assert len(r["id"]) == len(rows)
    assert (r["submit"] > 0).all()
    assert (r["submit"] <= r["dispatch"]).all() and (r["dispatch"] <= r["answer"]).all()
    t = trace.RECORDER.records(since=mark)
    batches = t["seq"][t["name"] == "serve.batch"]
    carried = np.unique(r["batch"])
    assert set(carried) <= set(batches)
    inside = np.isin(t["parent"], carried)
    n_rows = t["value"][inside & (t["name"] == "serve.rows")].sum()
    padded = t["value"][inside & (t["name"] == "serve.padded_rows")].sum()
    assert n_rows == len(rows) and n_rows + padded == len(carried) * svc.max_batch
    # every batch, the warm-up's included, counts max_batch rows in all
    all_rows = t["value"][t["name"] == "serve.rows"].sum()
    all_padded = t["value"][t["name"] == "serve.padded_rows"].sum()
    assert all_rows + all_padded == len(batches) * svc.max_batch


def test_the_profiling_tools_read_the_recorder():
    """``profile_train`` and ``profile_serve`` print what the recorder
    holds of their unprofiled runs in place of an idle share."""
    from mca_tpu_torch.tools import profile_serve, profile_train

    cfg = _config()
    rows = port_train.synthetic_rows(cfg, 4)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=10)
    batch = port_train.to_device(MultimodalCollator(cfg.modality_config.to_plain())(rows), "cpu")
    mark = trace.RECORDER.mark()
    for _ in range(2):
        port_train.train_step(model, opt, sched, batch)
    split = profile_train.phase_split(trace.RECORDER.records(since=mark))
    assert set(split) == {*profile_train.PHASES, "device_step_ms", "step_ms"}
    assert split["device_step_ms"] is None
    assert 0 < sum(split[p] for p in profile_train.PHASES) <= split["step_ms"]

    svc = EmbeddingService(cfg, max_batch=4, device="cpu")
    mark = trace.RECORDER.mark()
    for n in (1, 3):
        svc._materialise(svc._dispatch(rows[:n]), n)
    got = profile_serve.batch_split(trace.RECORDER.records(since=mark))
    assert got["forwards"] == 2 and got["device_ms"] is None and got["host_ms"] > 0
    assert (got["serve.rows"], got["serve.padded_rows"]) == (4, 4)
