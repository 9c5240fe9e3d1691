"""Where the time of one training step goes, on the GPU.

    python -m mca_tpu_torch.tools.profile_train [config.yaml] \\
        [--steps 5] [--bwd-impl fused|split] [--trace out.json]

Builds the trainer from the config (default ``configs/tcga_mca.yaml``:
TCGA_config1, batch 8, bf16 compute; ``configs/cmu_mca.yaml`` is
CMU_config1) with random weights from ``--seed`` and one synthetic batch
of rows shaped as the config's modalities (``train.synthetic_rows``,
p_missing 0.25), times the host's side of that batch as buckets of its
own (collate, and the copy to the device at fp32 and at bf16 staging,
with the bytes: ``tools.host_batch_costs``), takes 2 warm-up steps, times three windows of ``--steps`` steps on the
host clock (synchronised, no profiler), then runs ``--steps`` more under
``torch.profiler``.  Prints the host (CPU, load, a Python loop probe),
for each window its wall time, the process's CPU time and the probe
taken just before it; the recorder's split of the unprofiled windows'
steps (:mod:`mca_tpu_torch.utils.trace`: host ms a step in the
forward, the backward, the optimizer and the readback's wait, and the
step's device ms between its CUDA events); the wall time of the
profiled window (the profiler's own per-launch cost slows the host);
how far each ``mca.*`` range of the profiled window starts from the
recorder's stamp of the same span; the device time per step by kind
(K1, K2 or K3a / K3b, GEMMs, optimizer, norms / elementwise, copies),
the top kernels and host ops, and one JSON summary line.  ``--bwd-impl split`` sets
``flash_attention.default_bwd_impl`` for the run.
``num_warmup_steps`` is set to 2 so that the measured steps run at a
non-zero learning rate.  Needs a CUDA device.
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
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.staging import to_device
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.tools import (host_batch_costs, host_description, host_probe_ms,
                                 sample_tokens)
from mca_tpu_torch.train import build_trainer, synthetic_rows, train_step
from mca_tpu_torch.utils import trace

PHASES = ("train.forward", "train.backward", "train.optimizer", "train.readback")

DEFAULT_CONFIG = Path(__file__).resolve().parents[2] / "configs" / "tcga_mca.yaml"


def kind_of(name: str) -> str:
    """The kind a device kernel's time is summed under, by the kernel's
    name (``tools.profile_serve`` sorts by it too)."""
    for kernel, label in (
        ("flash_fwd", "flash_fwd (K1)"),
        ("flash_bwd_dq", "flash_bwd_dq (K3a)"),
        ("flash_bwd_kv_kernel<false>", "flash_bwd_dkv (K3b)"),
        ("flash_bwd_kv_kernel<true>", "flash_bwd (K2)"),
        ("flash_bwd_mla", "flash_bwd_mla (K2 at 192/128)"),
        ("geglu_ff", "geglu_ff (K5)"),
    ):
        if kernel in name:
            return label
    low = name.lower()
    if "multi_tensor" in low or "adam" in low:
        return "optimizer (AdamW)"
    if any(w in low for w in ("gemm", "xmma", "cutlass", "sm90", "nvjet", "splitk")):
        return "gemm (projections, FF, encoders, loss)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (norms, elementwise, reductions)"


def phase_split(records) -> dict:
    """Host ms a step in each of :data:`PHASES` and the steps' mean
    device ms (None without CUDA events), over the ``train.step`` spans
    of ``records`` (:meth:`~mca_tpu_torch.utils.trace.Recorder.records`)."""
    steps = records["name"] == "train.step"
    n = int(steps.sum())
    ms = (records["end"] - records["start"]) / 1e6
    inside = np.isin(records["parent"], records["seq"][steps])
    out = {p: float(ms[inside & (records["name"] == p)].sum()) / n for p in PHASES}
    dev = records["value"][steps]
    out["device_step_ms"] = float(dev.mean()) / 1e6 if n and (dev >= 0).all() else None
    out["step_ms"] = float(ms[steps].mean())
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("config", nargs="?", default=str(DEFAULT_CONFIG))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bwd-impl", choices=("fused", "split"), default="fused")
    p.add_argument("--trace", default=None, help="write a chrome trace here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]

    flash.default_bwd_impl = args.bwd_impl
    config = training_config(args.config)
    config.num_warmup_steps = 2
    config.seed = args.seed
    n = args.steps
    model, opt, sched = build_trainer(config, "cuda", num_training_steps=4 * n + 2)
    rows = synthetic_rows(config, int(config.batch_size))
    batch = to_device(MultimodalCollator(config.modality_config.to_plain())(rows), "cuda")
    host_batch = host_batch_costs(config, rows, "cuda")
    clip = float(config.clip or 0.0)
    for _ in range(2):
        train_step(model, opt, sched, batch, clip=clip)
    torch.cuda.synchronize()
    windows, cpu_ms, probes = [], [], []
    mark = trace.RECORDER.mark()
    for _ in range(3):
        probes.append(host_probe_ms())
        t0, c0 = time.perf_counter(), time.process_time()
        for _ in range(n):
            train_step(model, opt, sched, batch, clip=clip)  # ends in a sync
        windows.append((time.perf_counter() - t0) * 1e3)
        cpu_ms.append((time.process_time() - c0) * 1e3)
    wall_ms = sorted(windows)[1]
    split = phase_split(trace.RECORDER.records(since=mark))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    mark = trace.RECORDER.mark()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            train_step(model, opt, sched, batch, clip=clip)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    if args.trace:
        prof.export_chrome_trace(args.trace)
    offsets = [d for _, d in trace.kineto_offsets(prof.profiler.kineto_results.events(),
                                                  trace.RECORDER.records(since=mark))]

    per_kernel = defaultdict(float)
    for ev in prof.events():
        # record_function spans (e.g. "Optimizer.step#AdamW.step") also
        # appear on the device timeline; they cover kernels counted anyway
        if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            ev, "is_user_annotation", "#" in ev.name or ev.name.startswith(trace.PREFIX)
        ):
            per_kernel[ev.name] += ev.device_time_total / 1e3  # ms
    busy_ms = sum(per_kernel.values())
    by_kind = defaultdict(float)
    for name, ms in per_kernel.items():
        by_kind[kind_of(name)] += ms
    tokens = int(config.batch_size) * sample_tokens(config, model)
    host = host_description()
    print(card)
    print(host)
    print(f"{n} steps ({args.bwd_impl} backward) x 3 windows: "
          f"{', '.join(f'{w / n:.3f}' for w in windows)} ms wall each unprofiled "
          f"(median {wall_ms / n:.3f}, {tokens / wall_ms * n * 1e3:.1f} tokens/s), "
          f"process CPU {', '.join(f'{c / n:.3f}' for c in cpu_ms)} ms each, "
          f"probe before each window {', '.join(f'{x:.1f}' for x in probes)} ms; "
          f"{profiled_ms / n:.3f} ms wall each under the profiler; "
          f"{busy_ms / n:.3f} ms device busy each under the profiler")
    dev = split["device_step_ms"]
    print(f"recorder, unprofiled windows, ms a step: step {split['step_ms']:.3f}; "
          + "; ".join(f"{p[len('train.'):]} {split[p]:.3f}" for p in PHASES)
          + f"; device (CUDA events) {'not measured' if dev is None else f'{dev:.3f}'}")
    print(f"shared clock: {len(offsets)} mca.* ranges of the profiled window start "
          f"{min(offsets, default=0) / 1e3:.1f} to {max(offsets, default=0) / 1e3:.1f} us "
          f"from the recorder's stamps")
    print(f"host ms per batch (not in the step windows): collate "
          f"{host_batch['collate_ms']:.3f}; " + "; ".join(
              f"{sd} staging: narrow {c['narrow_ms']:.3f}, host-to-device copy "
              f"{c['copy_ms']:.3f} ({c['bytes']} bytes)"
              for sd, c in host_batch.items() if sd != "collate_ms"))
    print("device ms per step by kind:")
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms / n:9.4f}  {kind}")
    print("top kernels, device ms per step:")
    for name, ms in sorted(per_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {ms / n:9.4f}  {name[:110]}")
    # host side (under the profiler, which inflates it): where the
    # Python / dispatch time of a step goes
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print("top host ops by self CPU time, ms per step (profiled) and calls per step:")
    for e in host_ops[:12]:
        print(f"  {e.self_cpu_time_total / 1e3 / n:9.4f}  {e.count / n:7.1f}  {e.key[:90]}")
    print(json.dumps({
        "card": card,
        "host": host,
        "steps": n,
        "bwd_impl": args.bwd_impl,
        "wall_ms_per_step": wall_ms / n,
        "wall_ms_per_step_windows": [w / n for w in windows],
        "cpu_ms_per_step_windows": [c / n for c in cpu_ms],
        "probe_ms_windows": probes,
        "profiled_wall_ms_per_step": profiled_ms / n,
        "device_ms_per_step": busy_ms / n,
        "recorder_ms_per_step": split,
        "clock_offsets_us": [min(offsets, default=0) / 1e3, max(offsets, default=0) / 1e3],
        "tokens_per_s": tokens / wall_ms * n * 1e3,
        "by_kind_ms_per_step": {k: v / n for k, v in by_kind.items()},
        "host_batch_ms": host_batch,
    }))


if __name__ == "__main__":
    main()
