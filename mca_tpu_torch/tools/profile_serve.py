"""Where the time of one serving forward goes, on the GPU.

    python -m mca_tpu_torch.tools.profile_serve [config.yaml] \\
        [--forwards 10] [--quantize int8] [--trace out.json]

Builds ``EmbeddingService`` from the config (default
``configs/tcga_mca.yaml``: TCGA_config1, batch 8; ``configs/cmu_mca.yaml``
is CMU_config1) with random weights from ``--seed`` (``--quantize int8``:
quantised to int8, ``mca_tpu_torch.ops.quant``) on request rows
shaped as the config's modalities (``tools.request_rows``), times the
host's side of a batch as buckets of its own (collate, and the copy to
the device, ``tools.host_batch_costs``), warms it up, then runs ``--forwards`` batch-8 forwards
back to back (each dispatched while the previous one computes, as the
batcher does), once unprofiled and once under ``torch.profiler``.
Prints, for the unprofiled run, the wall time a forward and what the
recorder holds of it (:mod:`mca_tpu_torch.utils.trace`: host ms a
``serve.batch``, the forwards' median device ms between their CUDA
events, and the ``serve.rows`` / ``serve.padded_rows`` counts); for the
profiled one, the device time per forward by kernel and by kind (the
two ported kernels, GEMMs, the rest); and one JSON summary line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from mca_tpu_torch.config import training_config
from mca_tpu_torch.serve import QUANT_MODES, EmbeddingService
from mca_tpu_torch.tools import host_batch_costs, request_rows
from mca_tpu_torch.utils import trace

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


def run_forwards(svc, rows, n: int) -> float:
    """``n`` forwards of ``rows``, each dispatched while the previous one
    computes; returns the wall ms until the last is on the host."""
    t0 = time.perf_counter()
    inflight = None
    for _ in range(n):
        dev = svc._dispatch(rows)
        if inflight is not None:
            svc._materialise(inflight, len(rows))
        inflight = dev
    svc._materialise(inflight, len(rows))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def batch_split(records) -> dict:
    """What ``records`` (:meth:`~mca_tpu_torch.utils.trace.Recorder.records`)
    hold of their ``serve.batch`` spans: their number, host ms each, the
    median device ms (None without CUDA events) and the row counters."""
    batches = records["name"] == "serve.batch"
    inside = np.isin(records["parent"], records["seq"][batches])
    dev = records["value"][batches]
    return {
        "forwards": int(batches.sum()),
        "host_ms": float(((records["end"] - records["start"])[batches]).mean()) / 1e6,
        "device_ms": float(np.median(dev)) / 1e6 if (dev >= 0).all() else None,
        **{name: int(records["value"][inside & (records["name"] == name)].sum())
           for name in ("serve.rows", "serve.padded_rows")},
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", nargs="?", default=str(DEFAULT_CONFIG))
    p.add_argument("--forwards", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quantize", choices=QUANT_MODES, default="none")
    p.add_argument("--trace", default=None, help="write a chrome trace here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    config = training_config(args.config)
    svc = EmbeddingService(config, device="cuda", seed=args.seed, quantize=args.quantize)
    rows = request_rows(config, svc.max_batch)
    host_batch = host_batch_costs(config, rows, "cuda", stage_dtypes=("fp32",))
    for _ in range(3):
        svc._materialise(svc._dispatch(rows), len(rows))
    torch.cuda.synchronize()

    mark = trace.RECORDER.mark()
    wall_ms = run_forwards(svc, rows, args.forwards)
    split = batch_split(trace.RECORDER.records(since=mark))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        profiled_ms = run_forwards(svc, rows, args.forwards)
    if args.trace:
        prof.export_chrome_trace(args.trace)

    per_kernel = defaultdict(float)
    for ev in prof.events():
        # the recorder's mca.* ranges also appear on the device timeline
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            ev, "is_user_annotation", ev.name.startswith(trace.PREFIX)
        ):
            per_kernel[ev.name] += ev.device_time_total / 1e3  # ms
    busy_ms = sum(per_kernel.values())
    by_kind = defaultdict(float)
    for name, ms in per_kernel.items():
        by_kind[kind_of(name)] += ms
    n = args.forwards
    print(card)
    dev = split["device_ms"]
    print(f"quantize {args.quantize}: {n} batch-{svc.max_batch} forwards: {wall_ms / n:.3f} ms wall "
          f"each unprofiled, {profiled_ms / n:.3f} under the profiler, {busy_ms / n:.3f} ms "
          f"device busy each under the profiler")
    print(f"recorder, unprofiled run: {split['forwards']} serve.batch spans, host "
          f"{split['host_ms']:.3f} ms each, device (CUDA events, median) "
          f"{'not measured' if dev is None else f'{dev:.3f}'} ms; serve.rows "
          f"{split['serve.rows']}, serve.padded_rows {split['serve.padded_rows']}")
    print(f"host ms per batch (inside the wall above): collate "
          f"{host_batch['collate_ms']:.3f}, host-to-device copy "
          f"{host_batch['fp32']['copy_ms']:.3f} ({host_batch['fp32']['bytes']} bytes)")
    print("device ms per forward by kind:")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / n:9.4f}  {kind}")
    print("top kernels, device ms per forward:")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {ms / n:9.4f}  {name[:110]}")
    print(json.dumps({
        "card": card,
        "quantize": args.quantize,
        "forwards": n,
        "wall_ms_per_forward": wall_ms / n,
        "profiled_wall_ms_per_forward": profiled_ms / n,
        "device_ms_per_forward": busy_ms / n,
        "recorder": split,
        "by_kind_ms_per_forward": {k: v / n for k, v in by_kind.items()},
        "host_batch_ms": host_batch,
    }))


if __name__ == "__main__":
    main()
