"""Where the time of one serving forward goes, on the GPU.

    python -m mca_tpu_torch.tools.profile_serve [config.yaml] \\
        [--forwards 10] [--trace out.json]

Builds ``EmbeddingService`` from the config (default
``configs/tcga_mca.yaml``: TCGA_config1, batch 8) with random weights
from ``--seed``, warms it up, then runs ``--forwards`` batch-8 forwards
back to back (each dispatched while the previous one computes, as the
batcher does) under ``torch.profiler``.  Prints the device time per
forward by kernel and by kind (the two ported kernels, GEMMs, the rest),
the device busy share of the wall time, and one JSON summary line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

from mca_tpu_torch.config import training_config
from mca_tpu_torch.data.synthetic import tabular_rows
from mca_tpu_torch.serve import EmbeddingService

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "tcga_mca.yaml"


def kind_of(name: str) -> str:
    if "flash_fwd" in name:
        return "flash_fwd (K1)"
    if "geglu_ff" in name:
        return "geglu_ff (K5)"
    low = name.lower()
    if "gemm" in low or "xmma" in low or "cutlass" in low or "sm90" in low:
        return "gemm (projections, encoders)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (norms, elementwise, pooling)"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", nargs="?", default=str(DEFAULT_CONFIG))
    p.add_argument("--forwards", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--trace", default=None, help="write a chrome trace here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    config = training_config(args.config)
    svc = EmbeddingService(config, device="cuda", seed=args.seed)
    rows = tabular_rows(config.modality_config, svc.max_batch)
    for _ in range(3):
        svc._materialise(svc._dispatch(rows), len(rows))
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        inflight = None
        for _ in range(args.forwards):
            dev = svc._dispatch(rows)
            if inflight is not None:
                svc._materialise(inflight, len(rows))
            inflight = dev
        svc._materialise(inflight, len(rows))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)

    per_kernel = defaultdict(float)
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[ev.name] += ev.device_time_total / 1e3  # ms
    busy_ms = sum(per_kernel.values())
    by_kind = defaultdict(float)
    for name, ms in per_kernel.items():
        by_kind[kind_of(name)] += ms
    n = args.forwards
    print(card)
    print(f"{n} batch-{svc.max_batch} forwards: {wall_ms / n:.3f} ms wall each, "
          f"{busy_ms / n:.3f} ms device busy each, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    print("device ms per forward by kind:")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / n:9.4f}  {kind}")
    print("top kernels, device ms per forward:")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / n:9.4f}  {name[:110]}")
    print(json.dumps({
        "card": card,
        "forwards": n,
        "wall_ms_per_forward": wall_ms / n,
        "device_ms_per_forward": busy_ms / n,
        "idle_share": max(0.0, 1 - busy_ms / wall_ms),
        "by_kind_ms_per_forward": {k: v / n for k, v in by_kind.items()},
    }))


if __name__ == "__main__":
    main()
