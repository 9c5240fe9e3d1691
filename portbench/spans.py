"""What the readers of the program's own spans share: the recorder of the
run's process (``mca_tpu_torch.utils.trace.RECORDER``, rank 0's on
several chips) and the records of the unprofiled window.

Training: the window's steps are the last ``ctx["host"]["steps"]``
``train.step`` records that began with no profiler recording.  The
warm-up comes before them, and on the card both traced segments after
them run under a profiler, so the selection is exact there.  A CPU
rehearsal runs the device-only segment unrecorded
(:func:`portbench.trace.device_busy`), so there it ends inside that
segment.  The spans of a step are those whose parent is its
``train.step``; the loader's (one ``data.collate`` and one
``data.copy`` a step at ``prefetch_batches`` 0) are the last ``steps``
unprofiled records of their name.

Serving: the window's requests are the last ``ctx["host"]["rows"]``
unprofiled request records (a correct run has none failed), and its
forwards the ``serve.batch`` spans that carried them.

Each function returns None where the program has no recorder (a
checkout from before it), the window's records are no longer held, or
(the device readings) the run had no card."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

Table = Dict[str, np.ndarray]


def recorder():
    try:
        from mca_tpu_torch.utils.trace import RECORDER
    except ImportError:
        return None
    return RECORDER


def _last_unprofiled(t: Table, n: int) -> Optional[Table]:
    idx = np.flatnonzero(t["profiled"] == 0)
    if n <= 0 or len(idx) < n:
        return None
    idx = idx[-n:]
    return {k: v[idx] for k, v in t.items()}


def _ms(t: Table) -> np.ndarray:
    return (t["end"] - t["start"]) / 1e6


def window_steps(ctx: dict) -> Optional[Table]:
    rec = recorder()
    if rec is None:
        return None
    return _last_unprofiled(rec.records("train.step"), int(ctx["host"]["steps"]))


def loader_ms(ctx: dict, name: str) -> Optional[float]:
    """Host ms a step in the loader's spans ``name`` over the window."""
    rec = recorder()
    if rec is None:
        return None
    n = int(ctx["host"]["steps"])
    t = _last_unprofiled(rec.records(name), n)
    return None if t is None else float(_ms(t).sum()) / n


def _in_steps(ctx: dict, name: str):
    steps = window_steps(ctx)
    if steps is None:
        return None, None
    t = recorder().records(name)
    hit = np.isin(t["parent"], steps["seq"])
    return steps, {k: v[hit] for k, v in t.items()}


def phase_ms(ctx: dict, name: str) -> Optional[float]:
    """Host ms a step in the window's steps' spans ``name``."""
    steps, t = _in_steps(ctx, name)
    if steps is None or len(t["seq"]) == 0:
        return None
    return float(_ms(t).sum()) / len(steps["seq"])


def step_device_ms(ctx: dict) -> Optional[float]:
    """Device ms of a window step, from its first launch to the launch
    before its readback (CUDA events), the mean over the window."""
    if ctx["device_type"] != "cuda":
        return None
    steps = window_steps(ctx)
    if steps is None or (steps["value"] < 0).any():
        return None
    return float(steps["value"].mean()) / 1e6


def child_device_ms(ctx: dict, name: str) -> Optional[float]:
    """Device ms a step in the window's steps' timed spans ``name``."""
    if ctx["device_type"] != "cuda":
        return None
    steps, t = _in_steps(ctx, name)
    if steps is None or len(t["seq"]) == 0 or (t["value"] < 0).any():
        return None
    return float(t["value"].sum()) / 1e6 / len(steps["seq"])


def window_requests(ctx: dict) -> Optional[Table]:
    rec = recorder()
    if rec is None:
        return None
    r = _last_unprofiled(rec.requests(), int(ctx["host"]["rows"]))
    if r is None or (r["dispatch"] <= 0).any() or (r["answer"] <= 0).any():
        return None
    return r


def window_batches(ctx: dict) -> Optional[Table]:
    """The ``serve.batch`` spans that carried the window's requests."""
    r = window_requests(ctx)
    if r is None:
        return None
    t = recorder().records("serve.batch")
    hit = np.isin(t["seq"], np.unique(r["batch"]))
    return {k: v[hit] for k, v in t.items()}


def counted(name: str, parents: np.ndarray) -> int:
    """The sum of the counter ``name`` inside the spans ``parents``."""
    t = recorder().records(name)
    return int(t["value"][np.isin(t["parent"], parents)].sum())


def build_s(ctx: dict) -> Optional[float]:
    """Seconds in the program's outermost ``build.*`` spans (the process
    builds one trainer or one service)."""
    rec = recorder()
    if rec is None:
        return None
    t = rec.records(prefix="build.")
    top = ~np.isin(t["parent"], t["seq"])
    if not top.any():
        return None
    return float(_ms(t)[top].sum()) / 1e3
