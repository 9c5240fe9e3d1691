"""The profiler's record of a traced segment, reduced to intervals.

:func:`profiled` runs a function under ``torch.profiler`` with a
``pb.window`` span around it; :class:`Trace` keeps the device
operations (kernels, copies, sets), the benchmark's own ``pb.*`` spans
and the host's operations, each as ``(name, start_ns, end_ns)``, and
answers what the readers ask: device seconds of the operations whose
names match, the union of device time inside the window, the idle gaps
and what the host was doing in each.

Recording the host's operations slows the host, and with it the gaps
between kernels, so the idle share is read apart, by
:func:`device_busy`: a segment with the device's activity recorded
alone, its busy time over the same segment's wall time.
"""

from __future__ import annotations

import bisect
import time
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

Span = Tuple[str, int, int]
WINDOW = "pb.window"


class Trace:
    def __init__(self, device: Sequence[Span], spans: Sequence[Span], host: Sequence[Span]):
        self.device = sorted(device, key=lambda s: s[1])
        self.spans = list(spans)
        self.host = sorted(host, key=lambda s: s[1])
        win = [s for s in self.spans if s[0] == WINDOW]
        if win:
            self.start, self.end = win[0][1], win[0][2]
        else:
            self.start = min((s[1] for s in self.device), default=0)
            self.end = max((s[2] for s in self.device), default=0)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def matching(self, patterns: Iterable[str]) -> List[Span]:
        pats = tuple(patterns)
        return [s for s in self.device if any(p in s[0] for p in pats)]

    def device_seconds(self, patterns: Iterable[str]) -> Tuple[int, float]:
        """``(launches, device seconds)`` of the operations matching any
        of ``patterns`` inside the window."""
        hits = [s for s in self.matching(patterns) if s[1] >= self.start and s[2] <= self.end]
        return len(hits), sum(s[2] - s[1] for s in hits) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """Union of device intervals, clipped to the window."""
        out: List[List[int]] = []
        for _, a, b in self.device:
            a, b = max(a, self.start), min(b, self.end)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def idle_gaps(self) -> List[Tuple[int, int]]:
        gaps, t = [], self.start
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.end > t:
            gaps.append((t, self.end))
        return gaps

    def host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the innermost benchmark span,
        with the outermost host operation under it, else that operation
        alone, else ``host idle``."""
        spans = [s for s in self.spans if s[1] <= t < s[2] and s[0] != WINDOW]
        label = max(spans, key=lambda s: s[1])[0] if spans else ""
        i = bisect.bisect_right([s[1] for s in self.host], t)
        ops = [s for s in self.host[:i] if s[2] > t]
        op = min(ops, key=lambda s: s[1])[0] if ops else ""
        parts = [p for p in (label, op) if p]
        return " / ".join(parts) if parts else "host idle"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time and the longest idle
        gaps, each gap named by what the host was doing at its middle."""
        by_name: Dict[str, float] = {}
        for name, a, b in self.device:
            if a >= self.start and b <= self.end:
                by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[self.host_at((a + b) // 2)[:160], (b - a) / 1e9] for a, b in gaps],
        }


def from_kineto(events) -> Trace:
    """A :class:`Trace` from the profiler's kineto events."""
    device, spans, host = [], [], []
    for e in events:
        name = e.name()
        a = int(e.start_ns())
        b = a + int(e.duration_ns())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and not name.startswith("pb."):
                device.append((name, a, b))
        elif name.startswith("pb."):
            spans.append((name, a, b))
        elif not e.is_user_annotation():
            host.append((name, a, b))
    return Trace(device, spans, host)


def profiled(fn: Callable[[], None], device: torch.device) -> Trace:
    """Run ``fn`` under the profiler, inside a ``pb.window`` span that
    ends after the device has finished."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return from_kineto(prof.profiler.kineto_results.events())


class Busy(NamedTuple):
    busy_s: float
    window_s: float


def device_busy(fn: Callable[[], None], device: torch.device) -> Optional[Busy]:
    """Run ``fn`` with the device's activity recorded alone (no host
    operations, no spans); the union of the device's intervals, and the
    host's wall time from ``fn``'s start to the device's finish.  Off the
    card ``fn`` runs unrecorded and there is nothing to read."""
    if device.type != "cuda":
        fn()
        return None
    torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter_ns()
        fn()
        torch.cuda.synchronize(device)
        wall = time.perf_counter_ns() - t
    busy = from_kineto(prof.profiler.kineto_results.events()).busy_s
    return Busy(busy, wall / 1e9)


def span(name: str):
    """A benchmark span, seen by the profiler when it records."""
    return torch.profiler.record_function("pb." + name)
