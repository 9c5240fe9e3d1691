"""What the per-layer metric files share: a roofline share of matching
kernels, a whole-step share of the chip's peak, an idle share.  Each
returns None where the run has nothing to read (no trace, no matching
kernel, no card), so that the metric is left out of the line."""

from __future__ import annotations

from typing import Callable, Iterable, Optional

from portbench import counts


def roofline(ctx: dict, patterns: Iterable[str], work: Callable, what: str) -> Optional[float]:
    """The least time the launches' work could take at the cell's shapes
    (``work(cfg, launch_batch)`` a launch) over the device time of the
    kernels matching ``patterns``, in percent."""
    trace = ctx.get("trace")
    if ctx["device_type"] != "cuda" or trace is None:
        return None
    n, seconds = trace.device_seconds(patterns)
    if n == 0:
        return None
    flops, nbytes = work(ctx["cfg"], ctx["launch_batch"])
    return counts.share(n * counts.bound_seconds(flops, nbytes), seconds, what)


def mfu(ctx: dict, flops: float, what: str) -> Optional[float]:
    """``flops`` of model work done in the unprofiled window over what
    the chip's bf16 peak does in the window's wall time, in percent."""
    if ctx["device_type"] != "cuda":
        return None
    return counts.share(flops / counts.PEAK_BF16_FLOPS, ctx["host"]["elapsed_s"], what)


def idle_share(ctx: dict) -> Optional[float]:
    """The share of the segment recorded with the device's activity alone
    (``ctx["busy"]``, :func:`portbench.trace.device_busy`) in which no
    operation ran on the device, in percent."""
    busy = ctx.get("busy")
    if ctx["device_type"] != "cuda" or busy is None or busy.busy_s <= 0:
        return None
    return 100.0 * (1.0 - busy.busy_s / busy.window_s)
