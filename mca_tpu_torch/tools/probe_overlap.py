"""Can the tensor cores and the MUFU work at once inside one kernel?

    python -m mca_tpu_torch.tools.probe_overlap [--iters 16] \\
        [--ctl-steps 64] [--ctl-dots 1]

The port of ``baselines/probe_overlap.py``.  Two independent chains, a
matrix chain (wgmma, HGMMA in the SASS) and an exp chain (MUFU.EX2), run
alone and together in one instruction stream (K7,
``csrc/probe_overlap.cu``): in the combined body each warpgroup runs its
exp steps between the issue of its products and the wait for them.  If
the combined body takes about the sum of the two, the MUFU does not work
while the warpgroup's own products are in flight, and the flash kernels'
softmax needs another warpgroup (as FlashAttention-3's ping-pong) to
hide under the products; if it takes about the larger of the two, it
does.

The positive control (K8, ``csrc/probe_overlap_ctl.cu``) runs the same
method where overlap is known to exist: a double-buffered bulk-copy
stream (``ctl_dma``) against the matrix chain (``ctl_mxu``) and both at
once (``ctl_both``).  A SERIAL control verdict means the instrument
cannot see overlap, and then the probe's verdict means nothing.

Each time is the per-iteration (per-step) difference between a full and
a half-length launch, as in ``tools/roofline.py``; every block chains its
own copy, on as many blocks as reside on the card at once.  ``--iters``
(probe iterations) and ``--ctl-steps`` (control steps) are the starting
lengths; they grow until the full launch takes 20 ms.  The exp arm's
length is fixed, ``probes.EXP_CALLS`` steps an iteration, where it takes
about as long as the matrix arm.  ``--ctl-dots`` (chained products per
control step) is sized so that ``ctl_mxu`` alone takes about as long as
``ctl_dma`` alone, where the control separates overlap from the sum best;
both are printed.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mca_tpu_torch.ops import probes
from mca_tpu_torch.tools.roofline import (
    PEAK_BYTES,
    RATE_SLACK,
    per_iteration_s,
    require_cuda,
    sm_clock_mhz,
    smi,
)

N_CHUNKS = 8192  # K8's source: 8192 chunks of 44 KB, 352 MB of fp32 (seven times L2)
CTL_SCALE = 1.0 + 1e-6


def overlap_record(times: dict, control_times: dict) -> dict:
    """The probe's verdicts from per-iteration seconds of ``mxu``,
    ``vpu``, ``both`` and per-step seconds of ``ctl_dma``, ``ctl_mxu``,
    ``ctl_both``.  A verdict is OVERLAPS when the combined body recovers
    more than half the ideal headroom, serial - max, and SERIAL
    otherwise: a fixed fraction of the serial sum would mislabel
    unbalanced arms (with 12.7 and 5.0 us, even perfect overlap reaches
    only 0.72 of the sum)."""
    serial = times["mxu"] + times["vpu"]
    overlap = max(times["mxu"], times["vpu"])
    ctl_serial = control_times["ctl_dma"] + control_times["ctl_mxu"]
    ctl_overlap = max(control_times["ctl_dma"], control_times["ctl_mxu"])
    return {
        "us_per_iter": {k: round(v * 1e6, 4) for k, v in times.items()},
        "serial_bound_us": round(serial * 1e6, 4),
        "overlap_bound_us": round(overlap * 1e6, 4),
        "overlap_fraction": round(
            (serial - times["both"]) / max(serial - overlap, 1e-12), 3
        ),
        "verdict": (
            "OVERLAPS" if (serial - times["both"]) > 0.5 * (serial - overlap) else "SERIAL"
        ),
        "control_us_per_step": {k: round(v * 1e6, 4) for k, v in control_times.items()},
        "control_serial_bound_us": round(ctl_serial * 1e6, 4),
        "control_overlap_bound_us": round(ctl_overlap * 1e6, 4),
        "control_overlap_fraction": round(
            (ctl_serial - control_times["ctl_both"]) / max(ctl_serial - ctl_overlap, 1e-12), 3
        ),
        "control_verdict": (
            "OVERLAPS"
            if (ctl_serial - control_times["ctl_both"]) > 0.5 * (ctl_serial - ctl_overlap)
            else "SERIAL"
        ),
    }


def probe_inputs(n_blocks: int, device, seed: int = 0, n_chunks: int = N_CHUNKS):
    """Seeded inputs, as the TPU tool drew them: ``a`` ~ N(0, 0.06^2)
    bf16 per block, ``w`` ~ N(0, 1/256) bf16 (near-orthogonal, so the
    chain stays bounded), ``b`` ~ N(0, 1) fp32 per block, ``x`` ~ N(0, 1)
    fp32 chunks for the control and ``y`` its output."""
    rng = np.random.default_rng(seed)
    w_ = probes.CHAIN_W
    a = torch.from_numpy(rng.standard_normal((n_blocks, probes.CHAIN_ROWS, w_)) * 0.06)
    w = torch.from_numpy(rng.standard_normal((w_, w_)) / np.sqrt(w_))
    b = torch.from_numpy(rng.standard_normal((n_blocks, *probes.EXP_SHAPE)))
    x = torch.from_numpy(rng.standard_normal((n_chunks, *probes.CHUNK_SHAPE)).astype(np.float32))
    return {
        "a": a.to(torch.bfloat16).to(device),
        "w": w.to(torch.bfloat16).to(device),
        "b": b.float().to(device),
        "x": x.to(device),
        "y": torch.zeros_like(x, device=device),
    }


def run(iters: int = 16, ctl_steps: int = 64, ctl_dots: int = 1,
        min_ms: float = 20.0) -> dict:
    """Time the six arms on the card; returns :func:`overlap_record`
    with the card, its SM clock before and after, and the sizes."""
    require_cuda("the overlap probe")
    dev = torch.device("cuda")
    clock_before = sm_clock_mhz()
    n = probes.probe_blocks()
    n_ctl = probes.ctl_blocks()
    t = probe_inputs(max(n, n_ctl), dev)
    a, b = t["a"][:n].contiguous(), t["b"][:n].contiguous()
    a_ctl = t["a"][:n_ctl].contiguous()
    times, control, used = {}, {}, {}
    for mode in probes.PROBE_MODES:
        times[mode], used[mode] = per_iteration_s(
            lambda it: probes.probe_overlap(mode, a, t["w"], b, it), iters, min_ms
        )
    for mode in probes.CTL_MODES:
        control[mode], used[mode] = per_iteration_s(
            lambda st: probes.probe_overlap_ctl(
                mode, t["x"], t["y"], a_ctl, t["w"], st, ctl_dots, CTL_SCALE
            ),
            ctl_steps, min_ms,
        )
    # the copy stream cannot beat device memory: a faster reading means a
    # broken instrument
    step_bytes = 2.0 * n_ctl * t["x"][0].numel() * 4
    dma_rate = step_bytes / control["ctl_dma"]
    if not 0 < dma_rate <= RATE_SLACK * PEAK_BYTES:
        raise RuntimeError(
            f"ctl_dma moves {dma_rate / 1e12:.3f} TB/s, outside (0, {RATE_SLACK}] of "
            f"{PEAK_BYTES / 1e12} TB/s: {used['ctl_dma']}"
        )
    rec = overlap_record(times, control)
    rec.update({
        "ctl_dma_bytes_s": dma_rate,
        "device": torch.cuda.get_device_name(0),
        "card": smi("name,power.limit"),
        "clocks_sm_mhz_before": clock_before,
        "clocks_sm_mhz_after": sm_clock_mhz(),
        "blocks": {"probe": n, "control": n_ctl},
        "iters_used": used,
        "ctl_dots": ctl_dots,
    })
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=16,
                    help="starting iterations of the probe arms (grow until 20 ms)")
    ap.add_argument("--ctl-steps", type=int, default=64,
                    help="starting steps (chunks each block streams) of the control arms")
    ap.add_argument("--ctl-dots", type=int, default=1,
                    help="chained [128 x 256] x [256 x 256] products per control step")
    args = ap.parse_args(argv)
    rec = run(args.iters, args.ctl_steps, args.ctl_dots)
    for k in ("us_per_iter", "control_us_per_step"):
        print(f"  {k}: {rec[k]}", flush=True)
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
