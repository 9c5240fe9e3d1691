"""Measurement tools.  :func:`host_description` names the host beside
every wall-clock figure they print: a step that waits on the host runs
as fast as the host it lands on."""

from __future__ import annotations

import os
import platform
import time

import torch


def host_probe_ms(n: int = 1_000_000) -> float:
    """Milliseconds of a fixed single-threaded Python loop: how fast the
    interpreter runs on this host right now, which bounds the launch
    rate of a host-bound step."""
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i
    return (time.perf_counter() - t0) * 1e3


def host_description() -> str:
    """CPU (``/proc/cpuinfo`` where it names one), cores (all / usable
    by this process), torch's intra-op threads, the load averages and
    :func:`host_probe_ms`, as one line."""
    info = {}
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                info.setdefault(key.strip(), value.strip())
    cpu = info.get("model name") or " ".join(
        f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model") if k in info
    ) or platform.processor() or platform.machine()
    if "cpu MHz" in info:
        cpu += f" at {info['cpu MHz']} MHz"
    usable = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else "?"
    load = " ".join(f"{x:.2f}" for x in os.getloadavg())
    return (
        f"host: {cpu}, {os.cpu_count()} cores ({usable} usable), torch threads "
        f"{torch.get_num_threads()}, load average {load}, Python loop probe "
        f"{host_probe_ms():.1f} ms"
    )
