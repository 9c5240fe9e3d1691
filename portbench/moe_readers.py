"""What the routed-expert metrics read: the program's counters
``moe.held_tokens`` / ``moe.held_max`` (one of each a routed layer a
step, recorded inside ``train.step`` after its readback) and the device
times of its ``moe.*`` spans (inside ``train.forward``), over the
window's unprofiled steps (:func:`portbench.spans.window_steps`), and
the counters of the last profiled segment for a roofline.  Each returns
None where the program has no such record (a checkout from before it)."""

from __future__ import annotations

from typing import Optional

import numpy as np

from portbench import counts, moonlight_counts, spans


def window_counts(ctx: dict, name: str) -> Optional[np.ndarray]:
    """The counter ``name`` of the window's steps, ``[steps, layers]``."""
    steps = spans.window_steps(ctx)
    if steps is None:
        return None
    t = spans.recorder().records(name)
    v = t["value"][np.isin(t["parent"], steps["seq"])]
    n = len(steps["seq"])
    if len(v) == 0 or len(v) % n:
        return None
    return v.reshape(n, -1).astype(np.float64)


def load_ratio(ctx: dict) -> Optional[float]:
    """The most assignments on one held expert over the held experts'
    mean, averaged over the window's steps and routed layers."""
    held = window_counts(ctx, "moe.held_tokens")
    most = window_counts(ctx, "moe.held_max")
    if held is None or most is None or held.shape != most.shape or (held <= 0).any():
        return None
    return float((most / (held / moonlight_counts.held(ctx["cfg"]))).mean())


def device_ms(ctx: dict) -> Optional[float]:
    """Device ms a step inside the ``moe.*`` spans of the window's steps."""
    if ctx["device_type"] != "cuda":
        return None
    steps = spans.window_steps(ctx)
    if steps is None:
        return None
    rec = spans.recorder()
    fwd = rec.records("train.forward")
    fwd_seq = fwd["seq"][np.isin(fwd["parent"], steps["seq"])]
    t = rec.records(prefix="moe.")
    hit = np.isin(t["parent"], fwd_seq) & (t["start"] < t["end"])
    if not hit.any() or (t["value"][hit] < 0).any():
        return None
    return float(t["value"][hit].sum()) / 1e6 / len(steps["seq"])


def expert_gemm_roofline(ctx: dict, patterns, what: str) -> Optional[float]:
    """The least time of the grouped expert products' work over their
    kernels' device time in the profiled segment, in percent: the work
    is what the held assignments of that segment's steps (the last
    ``traced_steps`` profiled ``moe.held_tokens`` records a layer) ask
    for."""
    trace = ctx.get("trace")
    if ctx["device_type"] != "cuda" or trace is None:
        return None
    n, seconds = trace.device_seconds(patterns)
    rec = spans.recorder()
    if n == 0 or rec is None:
        return None
    t = rec.records("moe.held_tokens")
    want = int(ctx["host"]["traced_steps"]) * moonlight_counts.moe_layers(ctx["cfg"])
    v = t["value"][t["profiled"] == 1][-want:]
    if want == 0 or len(v) < want:
        return None
    bound = sum(counts.bound_seconds(*moonlight_counts.expert_gemm_work(ctx["cfg"], m)) for m in v)
    return counts.share(bound, seconds, what)
