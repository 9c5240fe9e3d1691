"""One rank of one run: set up the cell's driver, measure, check, print."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from portbench import harness


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "card: none (CPU rehearsal)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"card: {torch.cuda.get_device_name(device)}; nvidia-smi: {out.splitlines()[0] if out else ''}"


def execute(args, bench: dict, cell: dict, t0: float) -> int:
    from mca_tpu_torch.parallel.multihost import init_multihost, process_count, process_index

    init_multihost(device=args.device)
    rank, world = process_index(), process_count()
    device = torch.device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    data = Path(args.data)
    cfg = harness.config_of(bench, harness.ROOT.parent, cell["config"])
    traffic = harness.load_json(data / "traffic" / f"{cell['traffic']}.json")
    limits_path = data / "limits" / f"{cell['name']}.json"
    run = harness.Run(
        cell=cell, cfg=cfg, traffic=traffic,
        limits=harness.load_json(limits_path) if limits_path.exists() else {},
        seed=int(args.seed), seconds=float(args.seconds), trace=bool(args.trace),
        device=device, rank=rank, world=world)
    if rank == 0:
        print(card_line(device), file=sys.stderr, flush=True)
    out = harness.driver(traffic["driver"]).run(run)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    if rank != 0:
        return 0
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    e2e, layer = harness.metrics_of_cell(bench, cell["name"])
    metrics = {}
    breakdown = None
    if not run.trace:
        values = dict(out.e2e, setup_s=out.window_start - t0)
        for m in e2e:
            if m["name"] not in values:
                print(f"portbench: the driver measured no {m['name']}", file=sys.stderr)
                return 4
            metrics[m["name"]] = (values[m["name"]], m["unit"])
    else:
        for m in layer:
            v = harness.reader(m["name"])(out.ctx)
            if v is not None:
                metrics[m["name"]] = (v, m["unit"])
        trace = out.ctx.get("trace")
        if trace is not None and trace.device:
            breakdown = trace.breakdown()
    dev = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": world,
        "memory_peak_bytes": int(out.memory_peak_bytes),
    }
    if run.trace:
        dev["busy_s"] = out.busy_s
        dev["window_s"] = out.window_s
    correct = harness.check_verdict(out.checks) and out.failed == 0
    for name, v, lim in out.checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(harness.result_line(correct, out.attempted, out.failed, metrics, dev,
                              out.checks, breakdown), flush=True)
    return 0
