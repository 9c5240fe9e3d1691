#!/usr/bin/env python3
"""Drive the PyTorch port (``mca_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each asserted; any failure exits non-zero):

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
   build every kernel from ``mca_tpu_torch/csrc`` (one ``nvcc`` each, in
   parallel) and print ptxas's registers, spills and wgmma serialisation
   warnings; K1's and K5's SASS (``cuobjdump``) must hold HGMMA (wgmma)
   and UTMALDG (TMA) and no HMMA (mma.sync), with no spills.
2. K1, the flash-attention forward, against its plain version at
   TCGA_config1 shapes (B 8, H 8, T 2548, D 64, bf16, the real MCA
   mask, ragged key padding and a missing modality): live rows within
   bf16 tolerance, dead rows exactly 0 with lse NEG_INF; a planted fault
   (the plain forward with one partly masked tile dropped) must fail the
   same check.  Times: kernel, plain version, and
   ``F.scaled_dot_product_attention`` with the same mask as a yardstick
   (the port never calls it).
3. K5, the fused GEGLU feed-forward, against its plain version at
   N = 20384, D 512, inner 1365, bf16; a planted fault (the plain FF with
   one 64-wide inner chunk's W2 rows zeroed) must fail the same check.
   Yardsticks: the matmul -> gelu -> matmul chain on the unpadded W1
   (rows of 5460 bytes, not 16-byte aligned) and on the padded halves;
   the faster is ``library_ms``.
4. K2 (fused backward) and K3a + K3b (split backward) against the
   plain backward at K1's shapes and inputs with a random ``do``:
   dq, dk, dv within bf16 tolerance entry by entry and in relative L2
   per gradient, dead-row dq and padded-key dk / dv exactly 0, the two
   routes against each other; a planted fault (the plain backward with
   one partly masked tile dropped) must fail the relative-L2 check.
   Times: each kernel,
   the plain backward, and the backward alone of
   ``F.scaled_dot_product_attention`` with the same mask as a yardstick.
5. the serving slice: ``EmbeddingService`` at TCGA_config1 width (dim
   512, depth 5, 8 x 64 heads, T 2548, bf16, max_batch 8) on the GPU
   with weights from a fixed seed answers ``embed`` (20 rows, three
   pipelined chunks), ``submit`` from several threads and ``POST
   /embed`` over localhost HTTP; the three agree; K1 and K5 each
   launched 5 times per forward; the embeddings agree with the same
   weights run in fp32 on the CPU through the plain versions.
6. the training slice: the TCGA_config1 model (same widths and depth,
   bf16 compute, fp32 params, seed 0) takes 6 steps on a synthetic
   batch of 8 TCGA-shaped rows through ``mca_tpu_torch.train``, first
   with the fused backward (the main path: K1 and K2 5 times per step,
   K5 never), then with the split one (K3a and K3b 5 times per step);
   finite metrics, per-step losses of the two agree; from the same
   weights, the first step's q / kv-projection gradients of the two
   routes agree leaf by leaf (and a planted dq error fails that check),
   and the first step's loss, whole gradient and attention-projection
   gradients agree with fp32 on the CPU.  Prints the host, the ms of
   each step and training tokens/s.
7. the measurement slice: K6 (roofline counter), K7 (overlap probe) and
   K8 (its control) against their plain versions, mode by mode, every
   block's output after a few iterations from seeded inputs under which
   every product moves the chain, within bf16 tolerance (fp32 for the
   fp32 chains); planted faults must fail that check: each mode's plain
   chain one iteration (K7: one step of each chain, K8: one step) short,
   and the plain ``bwd5`` without dq, dv or dk.  Times of each mode,
   kernel and plain, and its bound.  Then the tools' main path, with the
   launch counts at 0 just before it: ``tools.roofline.measure_rates``'s
   short pass (every rate above 0 and within 105% of its published
   ceiling, each with the SM clock) and ``tools.probe_overlap.run`` at a
   short length (both verdicts printed; the control must read
   OVERLAPS, or the instrument cannot see overlap).
8. one ``{"kernels": [...]}`` line (eight kernels), then the last line
   ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM's published peaks (989 TFLOP/s dense bf16,
67 TFLOP/s fp32, i.e. 33.5 T fp32 instructions/s, 16 MUFU operations a
clock per SM on 132 SMs at 1980 MHz, 3.35 TB/s HBM3); the card's power
limit is printed beside them.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

import mca_tpu_torch
from mca_tpu_torch import _build
from mca_tpu_torch.config import get_model_config, training_config
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.synthetic import tabular_rows
from mca_tpu_torch.masks import build_masks
from mca_tpu_torch.models import build_model
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops import fused_ff as ff
from mca_tpu_torch.ops import probes
from mca_tpu_torch.serve import EmbeddingService, make_server
from mca_tpu_torch.tools import host_description, host_probe_ms
from mca_tpu_torch.tools import probe_overlap as overlap_tool
from mca_tpu_torch.tools import roofline as roofline_tool
from mca_tpu_torch.tools import sass_counts
from mca_tpu_torch.train import (
    build_trainer,
    forward_backward,
    synthetic_rows,
    to_device,
    train_step,
)

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "tcga_mca.yaml"
PEAK_BF16 = 989e12  # FLOP/s, dense
PEAK_BYTES = 3.35e12  # bytes/s
# bf16 results: two units in the last place relative, plus an absolute
# floor for values near zero where the operands' own rounding dominates
BF16_RTOL = 2.0**-6
FLASH_ATOL = 4e-3  # p is rounded to bf16 against different running maxima
FF_ATOL = 1e-3
# backward: kernel and plain version round p and ds to bf16 before the
# products that take them, but from fp32 values computed in another
# order (exp2 against exp, other running sums), so a few of those
# roundings land one unit (2^-8) apart; K2 also adds dq's fp32
# partials in an atomic order that changes from run to run; the
# gradients sum hundreds of such terms, so the gap is bounded by a
# fraction of the gradient's own largest entry: 1% of max |plain|, on
# top of BF16_RTOL
BWD_ATOL = 1e-2
# the same, over a whole gradient: relative L2 of kernel against plain.
# The few one-unit roundings apart give ~1.2e-4 (measured on an H100,
# fused and split alike); one partly masked 64 x 64 tile dropped from
# the plain backward (the tile with the median live count), the planted
# fault, gives ~2.9e-2, and must exceed the bound, as must the second
# planted fault, the second kv tile of a pair item dropped (2.9-3.0e-2,
# measured on an H100); 2e-3 sits ~15x from each, and also catches a
# dropped tile with 1-3% of that live count (6-7e-3 at these shapes)
BWD_REL_L2 = 2e-3
# a softmax scale whose bf16 is not a power of two: K2 and K3b then read
# q_s = bf16(q * bf16(scale)) from the wrapper instead of scaling in fp32
SCALE_NOT_POW2 = 0.1
# modality widths that give an odd number of 64-key tiles (T 160 with 22
# fusion tokens, two for each of the 11 modality combinations)
ODD_DIMS = (48, 30, 40, 20)
# embeddings, bf16 on the GPU vs fp32 on the CPU: relative L2 gap per key
# (bf16 rounds each activation to 8 significant bits, ~2e-3 relative;
# the final fp32 norm and pool average much of it out)
SLICE_REL_L2 = 1e-2
AGREE_ATOL = 1e-3  # embed vs submit vs HTTP: same kernels, batch-mates differ
TRAIN_STEPS = 6
TRAIN_WARMUP = 2  # lr is 0 at step 0 (as in the JAX schedule), then rises
# fused vs split backward, per-step total_loss: the two routes compute
# the same bf16 products and differ only in the order of dq's fp32 sums
# (step 0 agrees exactly), but one bf16 unit of dq moves near-zero
# gradient entries across 0, AdamW's early updates are about lr in size
# whatever the gradient's size, and the loss falls fourfold in these 6
# steps: the trajectories part by up to ~1% (measured 8.9e-3 at step 5
# on an H100), so 3e-2 relative.  AdamW's normalised updates also hide
# a dq that is off by a few percent here; the first-step gradient check
# (TRAIN_ROUTE_GRAD_REL_L2) is the one that tells the routes apart
TRAIN_SPLIT_RTOL = 3e-2
# first step, bf16 on the GPU vs fp32 on the CPU: the loss is an average
# of log-softmax terms of O(1) logits, which bf16 activations (8
# significant bits) move by well under 1%; the gradient carries the
# bf16 rounding of every activation and product through 5 blocks and the
# backward, so its relative L2 gap is a few percent at most
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
# leaf by leaf for the attention projections (to_q, to_kv, to_out of
# every block), which the flash backward feeds, so that a fault there
# cannot hide under the larger leaves of the flat vector: each leaf
# carries about the flat vector's gap (measured 8.0e-3 to 1.0e-2 on an
# H100), so 2e-2; the planted dq fault below must exceed it too
TRAIN_ATTN_GRAD_REL_L2 = 2e-2
# fused against split backward from the same weights, q / kv-projection
# gradients leaf by leaf: the routes differ only in the order of dq's
# fp32 sums, which moves a few bf16 roundings (measured at most 1.6e-3,
# in the first block, on an H100); dq wrong by a factor (1 + e) moves
# every block's to_q gradient by about e, so the planted fault (K3a's
# dq scaled by PLANTED_DQ_SCALE, measured 5.0e-2) must exceed the bound
TRAIN_ROUTE_GRAD_REL_L2 = 1e-2
PLANTED_DQ_SCALE = 1.05
PEAK_FP32 = 67e12  # FLOP/s, outside the tensor cores (an FFMA counts 2)
PEAK_FP32_ISSUE = PEAK_FP32 / 2  # fp32 instructions/s: 128 lanes a clock per SM
PEAK_MUFU = roofline_tool.rate_ceilings(1980.0, 132)["exp_elems_s"]  # 132 SMs at 1980 MHz
# measurement kernels against their plain versions, from seeded inputs
# under which every product moves the chain by several bf16 units
# (probes.counter_check_inputs; K7's b far from the exp chain's fixed
# point).  An entry passes within PROBE_RTOL of itself plus PROBE_RTOL of
# the tile's largest entry.  bf16: 2^-6, as the kernels round the same
# products to bf16 from fp32 sums taken in another order, so a few
# entries land one unit apart and the chain carries that on (float64
# sums in the plain chain, a stand-in for another order, reach 0.42 of
# it in bwd5).  fp32 (the vpu and exp chains): 1e-5, as both chains
# contract and ex2.approx is good to about 2^-22.  The planted faults
# put 56-100% of each mode's entries outside (one iteration or step
# short), and bwd5 without dq, dv or dk 36%, 66% and 72% (measured on
# an H100)
CHECK_ITERS = 4
PROBE_RTOL = {torch.bfloat16: 2.0**-6, torch.float32: 1e-5}
TIMED_ITERS = 256  # iterations of each K6 mode in its timed launch
TIMED_PROBE_ITERS = 8
TIMED_CTL_STEPS = 64
CTL_DOTS = 1


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn`` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float):
    """The larger of bytes over the HBM rate and ``n_ops`` bf16
    tensor-core operations over their peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def rel_l2(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.float(), ref.float()
    return float((x - ref).norm() / ref.norm())


def outside_bf16(kernel: torch.Tensor, plain: torch.Tensor, atol: float) -> int:
    """Entries of ``kernel`` outside bf16 tolerance of ``plain``."""
    k, p = kernel.float(), plain.float()
    return int(((k - p).abs() > atol + BF16_RTOL * p.abs()).sum())


def bf16_err(kernel: torch.Tensor, plain: torch.Tensor, atol: float) -> float:
    """Max |kernel - plain|; asserts it is within bf16 tolerance."""
    diff = float((kernel.float() - plain.float()).abs().max())
    n_out = outside_bf16(kernel, plain, atol)
    assert n_out == 0, f"{n_out} entries outside tolerance, max abs err {diff}"
    return diff


def flash_inputs(device, b=8, h=8, dims=(800, 198, 800, 662), fusion=88, seed=0):
    """q, k, v at the model's shapes, the real MCA mask, and key padding
    with ragged modality tails and one sample missing a modality."""
    ms = build_masks(list(dims), fusion, [4, 3, 2], fcl=True)
    t = ms.seq_len
    g = torch.Generator(device=device).manual_seed(seed)
    q, k, v = (
        torch.randn((b, h, t, 64), generator=g, device=device).to(torch.bfloat16)
        for _ in range(3)
    )
    pad = torch.zeros((b, t), dtype=torch.bool)
    starts = np.concatenate([[0], np.cumsum(dims)])
    rng = np.random.default_rng(seed)
    for i in range(b):
        for m in range(len(dims)):
            cut = int(rng.integers(dims[m] // 2, dims[m] + 1))
            pad[i, starts[m] + cut : starts[m + 1]] = True
    pad[1, starts[1] : starts[2]] = True  # sample 1 misses modality 1
    return ms.attn_mask, q, k, v, pad.to(device)


def check_flash(device, b=8, h=8) -> dict:
    mask, q, k, v, pad = flash_inputs(device, b=b, h=h)
    b, h, t, d = q.shape
    scale = d**-0.5
    with torch.inference_mode():
        out, lse = flash.flash_attention(q, k, v, mask, pad, scale)
        ref, ref_lse = flash.flash_attention_reference(q, k, v, mask, pad, scale)
        torch.cuda.synchronize()
        blocked = torch.from_numpy(mask).to(device)[None] | pad[:, None, :]
        live = ~blocked.all(dim=2)  # [B, T]
        live_bh = live[:, None, :].expand(b, h, t)
        err = bf16_err(out[live_bh], ref[live_bh], FLASH_ATOL)
        assert bool((out[~live_bh] == 0).all()), "dead rows are not zero"
        assert bool((lse[~live_bh] == flash.NEG_INF).all())
        lse_err = float((lse[live_bh] - ref_lse[live_bh]).abs().max())
        assert lse_err < 1e-3, lse_err
        assert int((~live).sum()) > 0  # the check covered dead rows
        # the planted fault: the plain forward with one partly masked tile
        # dropped must put live entries outside the same tolerance
        qi, kj, n_live = planted_tile(mask, pad)
        faulty_mask = mask.copy()
        faulty_mask[qi * flash.BLOCK : (qi + 1) * flash.BLOCK,
                    kj * flash.BLOCK : (kj + 1) * flash.BLOCK] = True
        faulty = flash.flash_attention_reference(q, k, v, faulty_mask, pad, scale)[0]
        flagged = outside_bf16(out[live_bh], faulty[live_bh], FLASH_ATOL)
        del faulty
        assert flagged > 0, "planted fault passes: a dropped tile"

        sdpa_mask = ~blocked[:, None]  # True = may attend
        ms = cuda_ms(lambda: flash.flash_attention(q, k, v, mask, pad, scale), 20)
        plain_ms = cuda_ms(
            lambda: flash.flash_attention_reference(q, k, v, mask, pad, scale), 3, 1
        )
        lib_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, attn_mask=sdpa_mask, scale=scale
            ),
            20,
        )
    # this run's work: every (query, key) pair the static mask and the
    # padding leave, two products of depth 64 each, over all heads
    pairs = float((~blocked).sum()) * h
    n_ops = 4.0 * d * pairs
    n_bytes = 4 * q.numel() * 2 + lse.numel() * 4 + mask.size + pad.numel()
    bms, by = bound_ms(n_bytes, n_ops)
    print(
        f"K1 flash_fwd: max_abs_err {err:.3e} (lse {lse_err:.3e}), "
        f"{ms:.4f} ms kernel, {plain_ms:.4f} ms plain, {lib_ms:.4f} ms sdpa, "
        f"bound {bms:.4f} ms ({by}), {pairs:.4g} live score entries; planted fault "
        f"(tile q{qi} x kv{kj}, {n_live} live entries over the batch, dropped) puts "
        f"{flagged} entries outside tolerance",
        flush=True,
    )
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "mca_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "mca_tpu/ops/flash_attention.py:196",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": lib_ms,
    }


def median_tile(tiles: list):
    """The (q tile, kv tile, live entries) with the median live count of
    ``tiles`` ``[(count, q tile, kv tile)]``."""
    cnt, i, j = sorted(tiles)[len(tiles) // 2]
    return i, j, cnt


def tile_live(mask: np.ndarray, pad: torch.Tensor, i: int, j: int) -> int:
    """Live entries of tile (q tile i, kv tile j) over the batch."""
    bl = flash.BLOCK
    live = ~torch.from_numpy(mask[i * bl : (i + 1) * bl, j * bl : (j + 1) * bl])[None]
    return int((live & ~pad.cpu()[:, None, j * bl : (j + 1) * bl]).sum())


def planted_tile(mask: np.ndarray, pad: torch.Tensor):
    """The (q tile, kv tile) that the planted fault drops, and its live
    entries over the batch: of the tiles that the static mask leaves
    partly blocked (off the ragged edge) and the padding leaves some
    entry live, the one with the median count of live entries."""
    row_ptr, col_idx, full = flash.tile_schedule(mask)
    nt = len(row_ptr) - 1
    tiles = []
    for i in range(nt - 1):
        for n in range(row_ptr[i], row_ptr[i + 1]):
            j = int(col_idx[n])
            if not full[n] and j < nt - 1:
                cnt = tile_live(mask, pad, i, j)
                if cnt:
                    tiles.append((cnt, i, j))
    return median_tile(tiles)


def planted_pair_half(mask: np.ndarray, pad: torch.Tensor):
    """The second planted fault's tile, one that a pair walk could drop
    while its first half still runs: of the kv_pair_schedule items whose
    SECOND kv tile (2j + 1) is live but not full, off the ragged edge,
    and has some entry the padding leaves live, the one with the median
    count of live entries."""
    pair_ptr, pair_q, flags, _ = flash.kv_pair_schedule(mask)
    nt = -(-mask.shape[0] // flash.BLOCK)
    tiles = []
    for p in range(len(pair_ptr) - 1):
        j = 2 * p + 1
        for n in range(pair_ptr[p], pair_ptr[p + 1]):
            i = int(pair_q[n])
            if flags[n] & 2 and not flags[n] & 8 and max(i, j) < nt - 1:
                cnt = tile_live(mask, pad, i, j)
                if cnt:
                    tiles.append((cnt, i, j))
    return median_tile(tiles)


def check_flash_bwd(device) -> list:
    """K2 (fused) and K3a + K3b (split) against the plain backward and
    against each other, at the shapes and mask of ``check_flash``."""
    mask, q, k, v, pad = flash_inputs(device)
    b, h, t, d = q.shape
    scale = d**-0.5
    g = torch.Generator(device=device).manual_seed(1)
    do = torch.randn(q.shape, generator=g, device=device).to(torch.bfloat16)
    with torch.inference_mode():
        out, lse = flash.flash_attention(q, k, v, mask, pad, scale)
        delta = flash.attention_delta(out, do)
        args = (q, k, v, do, lse, delta, mask, pad, scale)
        ref = flash.flash_attention_bwd_reference(q, k, v, mask, pad, out, lse, do, scale)
        fused = flash.flash_attention_backward(q, k, v, mask, pad, out, lse, do, scale, "fused")
        split = flash.flash_attention_backward(q, k, v, mask, pad, out, lse, do, scale, "split")
        torch.cuda.synchronize()
        blocked = torch.from_numpy(mask).to(device)[None] | pad[:, None, :]
        dead = blocked.all(dim=2)[:, None, :].expand(b, h, t)  # dead query rows
        padded = pad[:, None, :].expand(b, h, t)  # padded keys
        # the planted faults: the plain backward with one tile dropped, a
        # partly masked tile of the q-major walk and the second kv tile of
        # a pair item (which the pair walk could drop beside a live first
        # half); each must fail the relative-L2 check on every gradient
        names = ("dq", "dk", "dv")
        for fault, (qi, kj, n_live) in (
            ("tile", planted_tile(mask, pad)),
            ("pair half", planted_pair_half(mask, pad)),
        ):
            faulty_mask = mask.copy()
            tq, tk = (slice(x * flash.BLOCK, (x + 1) * flash.BLOCK) for x in (qi, kj))
            faulty_mask[tq, tk] = True
            faulty = flash.flash_attention_bwd_reference(
                q, k, v, faulty_mask, pad, out, lse, do, scale
            )
            for name, r, f in zip(names, ref, faulty):
                a = r.float().abs()
                atol = BWD_ATOL * float(a.max())
                flagged = int(((f.float() - r.float()).abs() > atol + BF16_RTOL * a).sum())
                print(
                    f"backward {name}: max |plain| {float(a.max()):.4e}, median "
                    f"|plain| {float(a.median()):.4e}, entry tolerance {atol:.3e} + "
                    f"2^-6 relative; planted {fault} fault (tile q{qi} x kv{kj}, "
                    f"{n_live} live entries over the batch, dropped): "
                    f"relative L2 {rel_l2(f, r):.3e}, {flagged} entries past the "
                    f"entry tolerance",
                    flush=True,
                )
                assert rel_l2(f, r) > BWD_REL_L2, (fault, name, "planted fault passes")
            del faulty
        errs, rels = {}, {}
        for impl, grads in (("fused", fused), ("split", split)):
            for name, x, r in zip(names, grads, ref):
                rels[impl, name] = rel_l2(x, r)
            print(
                f"backward {impl}: relative L2 against plain "
                + ", ".join(f"{n} {rels[impl, n]:.3e}" for n in names),
                flush=True,
            )
            for name, x, r in zip(names, grads, ref):
                errs[impl, name] = bf16_err(x, r, BWD_ATOL * float(r.abs().max()))
                assert rels[impl, name] <= BWD_REL_L2, (impl, name, rels[impl, name])
            assert bool((grads[0][dead] == 0).all()), f"{impl}: dead-row dq is not 0"
            assert bool((grads[1][padded] == 0).all()), f"{impl}: padded-key dk is not 0"
            assert bool((grads[2][padded] == 0).all()), f"{impl}: padded-key dv is not 0"
        assert int(dead.sum()) > 0 and int(padded.sum()) > 0  # both were covered
        # K2 against K3a + K3b: dk and dv come from the same kernel body;
        # dq sums the same bf16 products, in fp32, in another order
        fused_vs_split = max(
            bf16_err(x, y, BWD_ATOL * float(y.abs().max())) for x, y in zip(fused, split)
        )
        route_rel = max(rel_l2(x, y) for x, y in zip(fused, split))
        assert route_rel <= BWD_REL_L2, route_rel
        # K2 and K3b take q_s from the wrapper where bf16(scale) is not a
        # power of two (ops/flash_attention.py _q_operand)
        out_b, lse_b = flash.flash_attention(q, k, v, mask, pad, SCALE_NOT_POW2)
        ref_b = flash.flash_attention_bwd_reference(
            q, k, v, mask, pad, out_b, lse_b, do, SCALE_NOT_POW2
        )
        for impl in ("fused", "split"):
            got = flash.flash_attention_backward(
                q, k, v, mask, pad, out_b, lse_b, do, SCALE_NOT_POW2, impl
            )
            rel_b = [rel_l2(x, r) for x, r in zip(got, ref_b)]
            print(
                f"backward {impl}, scale {SCALE_NOT_POW2}: relative L2 against "
                "plain " + ", ".join(f"{n} {x:.3e}" for n, x in zip(names, rel_b)),
                flush=True,
            )
            assert max(rel_b) <= BWD_REL_L2, (impl, SCALE_NOT_POW2, rel_b)
        del out_b, lse_b, ref_b, got
        # an odd number of kv tiles (T 160, 3 tiles): the last pair's
        # second tile lies past T, where its k and v load as zeros
        m_odd, q_o, k_o, v_o, pad_o = flash_inputs(device, b=2, h=2, dims=ODD_DIMS, fusion=22)
        assert -(-m_odd.shape[0] // flash.BLOCK) % 2 == 1
        do_o = torch.randn(q_o.shape, generator=g, device=device).to(torch.bfloat16)
        out_o, lse_o = flash.flash_attention(q_o, k_o, v_o, m_odd, pad_o, scale)
        ref_o = flash.flash_attention_bwd_reference(
            q_o, k_o, v_o, m_odd, pad_o, out_o, lse_o, do_o, scale
        )
        for impl in ("fused", "split"):
            got = flash.flash_attention_backward(
                q_o, k_o, v_o, m_odd, pad_o, out_o, lse_o, do_o, scale, impl
            )
            rel_o = [rel_l2(x, r) for x, r in zip(got, ref_o)]
            print(
                f"backward {impl}, T {m_odd.shape[0]} (odd kv tiles): relative L2 "
                "against plain " + ", ".join(f"{n} {x:.3e}" for n, x in zip(names, rel_o)),
                flush=True,
            )
            assert max(rel_o) <= BWD_REL_L2, (impl, "odd kv tiles", rel_o)
            padded_o = pad_o[:, None, :].expand(got[1].shape[:3])
            assert bool((got[1][padded_o] == 0).all() and (got[2][padded_o] == 0).all()), impl

        dq_acc = torch.zeros((b, h, t, d), dtype=torch.float32, device=device)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        ms = {
            "flash_bwd": cuda_ms(lambda: flash.flash_bwd(*args, dq_acc, dk, dv), 10),
            "flash_bwd_dq": cuda_ms(lambda: flash.flash_bwd_dq(*args, dq), 10),
            "flash_bwd_dkv": cuda_ms(lambda: flash.flash_bwd_dkv(*args, dk, dv), 10),
        }
        plain_ms = cuda_ms(
            lambda: flash.flash_attention_bwd_reference(q, k, v, mask, pad, out, lse, do, scale),
            3, 1,
        )
    # the yardstick: the backward alone of SDPA with the same boolean mask
    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=~blocked[:, None], scale=scale
    )
    lib_ms = cuda_ms(
        lambda: torch.autograd.grad(sdpa_out, (qg, kg, vg), do, retain_graph=True), 10
    )
    del sdpa_out

    # this run's work: every live (query, key) pair, over all heads;
    # products of depth 64: K2 five (s, dp, dv, dk, dq), K3a three (s,
    # dp, dq), K3b four (s, dp, dv, dk); bytes: the inputs read once
    # (q, k, v, do bf16; lse, delta fp32; mask; padding), the outputs
    # written once (bf16)
    pairs = float((~blocked).sum()) * h
    n_in = 4 * q.numel() * 2 + 2 * lse.numel() * 4 + mask.size + pad.numel()
    work = {
        "flash_bwd": (5, n_in + 3 * q.numel() * 2, "_fused_bwd_kernel", 337, "flash_bwd.cu"),
        "flash_bwd_dq": (3, n_in + q.numel() * 2, "_dq_kernel", 281, "flash_bwd_dq.cu"),
        "flash_bwd_dkv": (4, n_in + 2 * q.numel() * 2, "_dkv_kernel", 523, "flash_bwd_dkv.cu"),
    }
    entries = []
    for name, (products, n_bytes, tpu_name, line, src) in work.items():
        bms, by = bound_ms(n_bytes, 2.0 * d * products * pairs)
        impl = "fused" if name == "flash_bwd" else "split"
        outs = {"flash_bwd": ("dq", "dk", "dv"), "flash_bwd_dq": ("dq",),
                "flash_bwd_dkv": ("dk", "dv")}[name]
        err = max(errs[impl, o] for o in outs)
        print(
            f"{name} ({tpu_name}): max_abs_err {err:.3e} "
            f"({', '.join(f'{o} {errs[impl, o]:.3e}' for o in outs)}), "
            f"{ms[name]:.4f} ms kernel, {plain_ms:.4f} ms plain (dq, dk, dv), "
            f"{lib_ms:.4f} ms sdpa backward, bound {bms:.4f} ms ({by})",
            flush=True,
        )
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"mca_tpu_torch/csrc/{src}",
            "replaces": f"mca_tpu/ops/flash_attention.py:{line}",
            "max_abs_err": err,
            "ms": ms[name],
            "plain_ms": plain_ms,
            "bound_ms": bms,
            "bound_by": by,
            "library_ms": lib_ms,
        })
    print(
        f"backward: fused vs split max abs gap {fused_vs_split:.3e}, "
        f"relative L2 {route_rel:.3e}; "
        f"{int(dead.sum())} dead query rows, {int(padded.sum())} padded keys "
        f"(all heads); {pairs:.4g} live score entries",
        flush=True,
    )
    return entries


def check_ff(device, n=20384, dim=512, inner=1365, seed=0) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device=device).to(torch.bfloat16)
    w1 = ((torch.rand((dim, 2 * inner), generator=g, device=device) * 2 - 1)
          * dim**-0.5).to(torch.bfloat16)
    w2 = ((torch.rand((inner, dim), generator=g, device=device) * 2 - 1)
          * inner**-0.5).to(torch.bfloat16)
    prepared = ff.prepare_geglu_weights(w1, w2, torch.bfloat16)
    # the padded halves, contiguous: rows of 2816 bytes, 16-byte aligned
    w1u, w1g, w2p = (w.contiguous() for w in ff.split_geglu_weights(*prepared))
    with torch.inference_mode():
        out = ff.geglu_ff(x, *prepared)
        ref = ff.geglu_ff_reference(x, w1, w2)
        torch.cuda.synchronize()
        err = bf16_err(out, ref, FF_ATOL)
        # the planted fault: the plain FF with one 64-wide inner chunk's W2
        # rows zeroed must put entries outside the same tolerance
        chunk = prepared[1].shape[1] // ff.INNER_MULTIPLE // 2
        w2_fault = prepared[1].clone()
        w2_fault[:, chunk * ff.INNER_MULTIPLE : (chunk + 1) * ff.INNER_MULTIPLE] = 0
        flagged = outside_bf16(out, ff.geglu_ff_plain(x, prepared[0], w2_fault), FF_ATOL)
        assert flagged > 0, "planted fault passes: a W2 chunk zeroed"

        def chain():  # the unpadded [512, 2730] W1: rows of 5460 bytes
            u, gate = (x @ w1).chunk(2, dim=-1)
            return (torch.nn.functional.gelu(gate) * u) @ w2

        def chain_aligned():
            return (torch.nn.functional.gelu(x @ w1g) * (x @ w1u)) @ w2p

        ms = cuda_ms(lambda: ff.geglu_ff(x, *prepared), 20)
        plain_ms = cuda_ms(lambda: ff.geglu_ff_reference(x, w1, w2), 5)
        chain_ms = cuda_ms(chain, 20)
        aligned_ms = cuda_ms(chain_aligned, 20)
    n_ops = 6.0 * n * dim * inner
    n_bytes = 2.0 * (x.numel() + w1.numel() + w2.numel() + out.numel())
    bms, by = bound_ms(n_bytes, n_ops)
    print(
        f"K5 geglu_ff: max_abs_err {err:.3e}, {ms:.4f} ms kernel, "
        f"{plain_ms:.4f} ms plain, matmul-gelu-matmul {chain_ms:.4f} ms (unpadded W1) "
        f"and {aligned_ms:.4f} ms (padded halves), bound {bms:.4f} ms ({by}); planted "
        f"fault (W2 rows of inner chunk {chunk} zeroed) puts {flagged} entries outside "
        f"tolerance",
        flush=True,
    )
    return {
        "name": "geglu_ff",
        "route": "cuda",
        "source": "mca_tpu_torch/csrc/geglu_ff.cu",
        "replaces": "mca_tpu/ops/fused_ff.py:75",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bms,
        "bound_by": by,
        "library_ms": min(chain_ms, aligned_ms),
    }


def check_slice(config, device, cpu_device="cpu", n_rows=20) -> dict:
    svc = EmbeddingService(config, device=device, seed=0, max_batch=8)
    forwards = [0]
    svc.model.register_forward_hook(
        lambda *_: forwards.__setitem__(0, forwards[0] + 1)
    )
    rows = tabular_rows(config.modality_config, n_rows)

    # the main path, with every launch count at 0 just before it
    flash.launches = 0
    ff.launches = 0
    forwards[0] = 0
    via_embed = svc.embed(rows)
    svc.start()
    try:
        futs = []
        threads = [
            threading.Thread(target=lambda r=r: futs.append((r, svc.submit(rows[r]))))
            for r in range(8)
        ]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        via_submit = {r: f.result(timeout=120) for r, f in futs}
    finally:
        svc.stop()
    server = make_server(svc, port=0)
    serve_thread = threading.Thread(target=server.serve_forever, daemon=True)
    serve_thread.start()
    try:
        port = server.server_address[1]
        payload = {"rows": [{m: {"values": d["values"].tolist()} for m, d in row.items()}
                            for row in rows[:3]]}
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/embed",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            via_http = json.loads(r.read())
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()
    counts = {"flash_fwd": flash.launches, "geglu_ff": ff.launches}
    depth = len(svc.model.layers)
    print(f"slice: {forwards[0]} forwards, launches {counts}", flush=True)
    assert forwards[0] >= 4, forwards  # 3 chunks of embed + >= 1 batch
    for name, c in counts.items():
        assert c == depth * forwards[0], (name, c, forwards[0])

    # the three request paths agree
    agree = 0.0
    for k in svc.emb_keys:
        e = via_embed["embeddings"][k]
        assert e.shape == (n_rows, config.hidden_size) and np.isfinite(e).all(), k
        for r, res in via_submit.items():
            agree = max(agree, float(np.abs(res["embeddings"][k] - e[r]).max()))
        for r in range(3):
            agree = max(agree, float(np.abs(np.asarray(via_http["embeddings"][r][k]) - e[r]).max()))
    for r, res in via_submit.items():
        assert res["present"] == {k: bool(via_embed["present"][k][r]) for k in svc.mask_keys}
    assert agree <= AGREE_ATOL, agree
    assert not all(via_embed["present"][k].all() for k in svc.mask_keys)

    # the same weights in fp32 on the CPU through the plain versions
    cfg32 = type(config)(config)
    cfg32.precision = "fp32"
    cpu_svc = EmbeddingService(
        cfg32, params=svc.model.state_dict(), device=cpu_device,
        max_batch=8, warmup=False,
    )
    ref = cpu_svc.embed(rows[:8])
    rel = max(
        float(np.linalg.norm(via_embed["embeddings"][k][:8] - ref["embeddings"][k])
              / np.linalg.norm(ref["embeddings"][k]))
        for k in svc.emb_keys
    )
    for k in svc.mask_keys:
        np.testing.assert_array_equal(via_embed["present"][k][:8], ref["present"][k])
    assert rel <= SLICE_REL_L2, rel

    # steady-state forward time at max_batch 8
    batch_rows = rows[:8]
    iters = 10
    svc._materialise(svc._dispatch(batch_rows), 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        dev = svc._dispatch(batch_rows)
    svc._materialise(dev, 8)
    fwd_ms = (time.perf_counter() - t0) / iters * 1e3
    t0 = time.perf_counter()
    svc.embed(rows)
    embed_s = time.perf_counter() - t0
    print(
        f"slice: embed/submit/http max disagreement {agree:.3e}; "
        f"bf16 GPU vs fp32 CPU relative L2 {rel:.3e}; "
        f"{fwd_ms:.3f} ms per batch-8 forward ({8e3 / fwd_ms:.1f} rows/s); "
        f"embed of {n_rows} rows {embed_s * 1e3:.1f} ms ({n_rows / embed_s:.1f} rows/s)",
        flush=True,
    )
    return counts


def attention_leaves(grads: dict, projections=("to_q", "to_kv", "to_out")) -> list:
    """Names of the transformer blocks' attention-projection weights."""
    return [n for n in grads if n.startswith("layers.")
            and n.split(".")[-2] in projections]


def check_train(config, device, cpu_device="cpu", steps=TRAIN_STEPS) -> dict:
    """The training slice: TCGA_config1 at full width and depth on the
    GPU, ``steps`` steps through the fused backward (the main path) and
    again through the split one from the same weights; from those
    weights, the first step's gradients of the two routes against each
    other, and its loss and gradients against fp32 on the CPU."""
    config = type(config)(config)
    config.num_warmup_steps = TRAIN_WARMUP
    print(
        f"train: num_warmup_steps set to {TRAIN_WARMUP} (the config's "
        f"{training_config(str(CONFIG)).num_warmup_steps} would keep lr near 0 "
        f"for these {steps} steps)",
        flush=True,
    )
    rows = synthetic_rows(config, int(config.batch_size))
    collated = MultimodalCollator(config.modality_config.to_plain())(rows)
    init = build_model(get_model_config(config), fused_ff=False)
    init.init_weights(torch.Generator().manual_seed(0))
    params = {k: v.clone() for k, v in init.state_dict().items()}
    depth, tokens = len(init.layers), int(config.batch_size) * init.mask_set.seq_len

    print(host_description(), flush=True)
    runs, counts = {}, {}
    for impl in ("fused", "split"):
        flash.default_bwd_impl = impl
        model, opt, sched = build_trainer(
            config, device, num_training_steps=steps, params=params
        )
        batch = to_device(collated, device)
        # each path with every launch count at 0 just before it
        flash.launches = 0
        ff.launches = 0
        flash.bwd_launches.update(dict.fromkeys(flash.bwd_launches, 0))
        history, step_s, step_cpu_s = [], [], []
        probe = host_probe_ms()
        for _ in range(steps):
            torch.cuda.synchronize()
            t0, c0 = time.perf_counter(), time.process_time()
            history.append(train_step(model, opt, sched, batch, clip=float(config.clip)))
            step_s.append(time.perf_counter() - t0)  # train_step ends in a sync
            step_cpu_s.append(time.process_time() - c0)
        counts[impl] = {
            "flash_fwd": flash.launches, "geglu_ff": ff.launches, **flash.bwd_launches,
        }
        runs[impl] = (history, step_s, step_cpu_s, probe)
        print(f"train ({impl} backward): launches {counts[impl]}", flush=True)
        del model, opt, sched
    flash.default_bwd_impl = "fused"

    fused_c, split_c = counts["fused"], counts["split"]
    n = depth * steps
    assert fused_c == {"flash_fwd": n, "geglu_ff": 0, "flash_bwd": n,
                       "flash_bwd_dq": 0, "flash_bwd_dkv": 0}, fused_c
    assert split_c == {"flash_fwd": n, "geglu_ff": 0, "flash_bwd": 0,
                       "flash_bwd_dq": n, "flash_bwd_dkv": n}, split_c
    for impl, (history, *_) in runs.items():
        for m in history:
            for k in ("total_loss", "fcl_loss", "no-fcl_loss", "param_norm", "grad_norm"):
                assert math.isfinite(m[k]), (impl, k, m)
            # a pair whose presence mask is empty in this batch is NaN by
            # design (excluded from total_loss); nothing may be infinite
            assert not any(math.isinf(v) for v in m.values()), (impl, m)
    fused_loss = [m["total_loss"] for m in runs["fused"][0]]
    split_loss = [m["total_loss"] for m in runs["split"][0]]
    gap = max(abs(a - b) / abs(b) for a, b in zip(fused_loss, split_loss))
    assert gap <= TRAIN_SPLIT_RTOL, (fused_loss, split_loss)
    assert runs["fused"][0][-1]["lr"] > 0

    # the first step from the same weights: the loss and every gradient
    # (on the CPU, fp32), through each route on the GPU, through the
    # split route with a planted dq fault, and in fp32 on the CPU
    # through the plain versions
    def first_step(cfg, dev, impl="fused"):
        flash.default_bwd_impl = impl
        model = build_trainer(cfg, dev, params=params)[0]
        loss = float(forward_backward(model, to_device(collated, dev))["loss"].detach())
        flash.default_bwd_impl = "fused"
        return loss, {n: p.grad.float().cpu() for n, p in model.named_parameters()}

    gpu_loss, gpu = first_step(config, device, "fused")
    _, split = first_step(config, device, "split")
    real_dq = flash.flash_bwd_dq
    flash.flash_bwd_dq = lambda *a: (real_dq(*a), a[-1].mul_(PLANTED_DQ_SCALE))
    _, planted = first_step(config, device, "split")
    flash.flash_bwd_dq = real_dq
    cfg32 = type(config)(config)
    cfg32.precision = "fp32"
    t0 = time.perf_counter()
    cpu_loss, cpu = first_step(cfg32, cpu_device)
    cpu_step_s = time.perf_counter() - t0

    loss_rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    grad_rel = rel_l2(torch.cat([g.reshape(-1) for g in gpu.values()]),
                      torch.cat([g.reshape(-1) for g in cpu.values()]))
    attn = attention_leaves(gpu)
    qkv = attention_leaves(gpu, ("to_q", "to_kv"))
    attn_rel = {n: rel_l2(gpu[n], cpu[n]) for n in attn}
    route_rel = {n: rel_l2(split[n], gpu[n]) for n in qkv}
    planted_rel = {n: rel_l2(planted[n], gpu[n]) for n in qkv}
    planted_cpu = max(rel_l2(planted[n], cpu[n]) for n in qkv)
    print(
        "train: first-step gradients, relative L2 per leaf; bf16 GPU vs fp32 "
        f"CPU: {', '.join(f'{n} {x:.3e}' for n, x in attn_rel.items())}; "
        f"split vs fused: {', '.join(f'{n} {x:.3e}' for n, x in route_rel.items())}; "
        f"split with dq x {PLANTED_DQ_SCALE} vs fused: "
        f"{', '.join(f'{n} {x:.3e}' for n, x in planted_rel.items())}",
        flush=True,
    )
    assert loss_rel <= TRAIN_LOSS_RTOL, (gpu_loss, cpu_loss)
    assert grad_rel <= TRAIN_GRAD_REL_L2, grad_rel
    assert max(attn_rel.values()) <= TRAIN_ATTN_GRAD_REL_L2, attn_rel
    assert max(route_rel.values()) <= TRAIN_ROUTE_GRAD_REL_L2, route_rel
    assert max(planted_rel.values()) > TRAIN_ROUTE_GRAD_REL_L2, planted_rel
    assert planted_cpu > TRAIN_ATTN_GRAD_REL_L2, planted_cpu

    step_ms = 1e3 * float(np.mean(runs["fused"][1][1:]))
    split_ms = 1e3 * float(np.mean(runs["split"][1][1:]))
    def each(xs):
        return ", ".join(f"{1e3 * x:.3f}" for x in xs)

    print(
        f"train: total_loss fused {['%.5f' % x for x in fused_loss]}, "
        f"split {['%.5f' % x for x in split_loss]} (max relative gap {gap:.3e}); "
        f"first step bf16 GPU vs fp32 CPU: loss {gpu_loss:.6f} vs {cpu_loss:.6f} "
        f"(relative {loss_rel:.3e}), gradient relative L2 {grad_rel:.3e}, "
        f"attention projections at most {max(attn_rel.values()):.3e}; split vs "
        f"fused q / kv projections at most {max(route_rel.values()):.3e}, planted "
        f"dq fault {max(planted_rel.values()):.3e} (against fp32 CPU "
        f"{planted_cpu:.3e}) (CPU step {cpu_step_s:.1f} s, depth {depth})",
        flush=True,
    )
    for impl, (_, step_s, step_cpu_s, probe) in runs.items():
        print(
            f"train ({impl}): wall ms per step {each(step_s)}; process CPU ms "
            f"{each(step_cpu_s)}; Python loop probe before the run {probe:.1f} ms",
            flush=True,
        )
    print(host_description(), flush=True)
    print(
        f"train: {step_ms:.3f} ms per step with the fused backward, {split_ms:.3f} ms "
        f"with the split one (mean of steps 2-{steps}, host clock, synchronised); "
        f"{tokens / step_ms * 1e3:.1f} training tokens/s ({tokens} tokens per step)",
        flush=True,
    )
    return {"flash_bwd": fused_c["flash_bwd"], "flash_bwd_dq": split_c["flash_bwd_dq"],
            "flash_bwd_dkv": split_c["flash_bwd_dkv"]}


def probe_tol(plain: torch.Tensor) -> torch.Tensor:
    """Tolerance of each entry of a measurement kernel's output: PROBE_RTOL
    of the entry plus PROBE_RTOL of the largest, at its dtype's rtol."""
    p = plain.float().abs()
    return PROBE_RTOL[plain.dtype] * (p + p.max())


def outside(kernel: torch.Tensor, plain: torch.Tensor) -> int:
    """Entries of ``kernel`` outside tolerance of ``plain``."""
    return int(((kernel.float() - plain.float()).abs() > probe_tol(plain)).sum())


def probe_err(kernel: torch.Tensor, plain: torch.Tensor):
    """``(max |kernel - plain|, largest share of an entry's tolerance)``;
    asserts every entry is within tolerance."""
    diff = (kernel.float() - plain.float()).abs()
    share = float((diff / probe_tol(plain)).max())
    assert share <= 1.0, (
        f"{outside(kernel, plain)} entries outside tolerance, max abs err "
        f"{float(diff.max())}, {share:.2f} of tolerance"
    )
    return float(diff.max()), share


def planted(faults: dict) -> str:
    """Asserts that each planted fault, ``{what: (kernel output, plain
    version computed wrong)}``, puts entries outside tolerance; returns a
    note."""
    notes = []
    for what, (kernel, fault) in faults.items():
        n_out = outside(kernel, fault)
        assert n_out > 0, (what, "planted fault passes")
        notes.append(f"{what} {n_out / kernel.numel():.1%}")
    return "planted faults outside tolerance: " + ", ".join(notes)


def bwd5_dropped(q, kv, iters: int, eps: float, product: str):
    """The plain bwd5 chain with one product (dq, dv or dk) left out."""
    for _ in range(iters):
        p = probes.bwd5_products(q, kv[: probes.TILE], kv[probes.TILE :])
        p[product] = torch.zeros_like(p[product])
        fold = (p["dv"] + p["dk"]).sum(dim=-2, keepdim=True)
        q = (q.float() + (p["dq"] + fold) * eps).to(torch.bfloat16)
    return q


def launch_bound(n_bytes: float, bf16_ops: float = 0.0, fp32_instr: float = 0.0,
                 mufu_ops: float = 0.0):
    """One measurement launch's bound, ``(ms, by)``: the larger of its
    bytes over the HBM rate and its slowest unit, which runs beside the
    others: tensor-core operations over the bf16 peak, fp32 instructions
    over the FP32 pipe's issue rate, MUFU operations over the MUFU rate."""
    t_bytes = n_bytes / PEAK_BYTES
    t_ops = max(bf16_ops / PEAK_BF16, fp32_instr / PEAK_FP32_ISSUE, mufu_ops / PEAK_MUFU)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_entry(name, tpu_line, errs, ms, plain_ms, bounds) -> dict:
    """The kernels-line entry of a measurement kernel: the sums over its
    modes' timed launches; ``bounds`` holds each launch's
    :func:`launch_bound`."""
    by = {"bytes": 0.0, "operations": 0.0}
    for b_ms, b_by in bounds.values():
        by[b_by] += b_ms
    return {
        "name": name,
        "route": "cuda",
        "source": f"mca_tpu_torch/csrc/{name}.cu",
        "replaces": tpu_line,
        "max_abs_err": max(errs.values()),
        "ms": sum(ms.values()),
        "plain_ms": sum(plain_ms.values()),
        "bound_ms": sum(by.values()),
        "bound_by": max(by, key=by.get),
        "library_ms": None,
        "modes_ms": ms,
        "modes_bound_ms": {m: b[0] for m, b in bounds.items()},
    }


def check_counter(device) -> dict:
    """K6, every mode on as many blocks as reside at once: the check
    after CHECK_ITERS iterations from ``probes.counter_check_inputs``, the
    planted faults, and one launch of TIMED_ITERS iterations at the rate
    pass's inputs (kernel and plain); the entry sums the five launches."""
    errs, ms, plain_ms, bounds = {}, {}, {}, {}
    for mode in probes.COUNTER_MODES:
        n = probes.counter_blocks(mode)
        x0, aux, const = probes.counter_check_inputs(mode, n, seed=7)
        x0, aux = x0.to(device), (aux.to(device) if aux is not None else None)
        out = probes.roofline_counter(mode, x0, aux, CHECK_ITERS, const)
        ref = probes.counter_reference(mode, x0, aux, CHECK_ITERS, const)
        torch.cuda.synchronize()
        errs[mode], share = probe_err(out, ref)
        faults = {"one iteration short": (out, probes.counter_reference(
            mode, x0, aux, CHECK_ITERS - 1, const))}
        if mode == "bwd5":
            for product in ("dq", "dv", "dk"):
                faults[f"{product} dropped"] = (
                    out, bwd5_dropped(x0, aux, CHECK_ITERS, const, product))
        note = planted(faults)
        work, t_const, fill = roofline_tool.COUNTER_WORK[mode]
        xt, auxt = roofline_tool.counter_inputs(mode, n, device, fill)
        ms[mode] = cuda_ms(
            lambda: probes.roofline_counter(mode, xt, auxt, TIMED_ITERS, t_const), 5
        )
        plain_ms[mode] = cuda_ms(
            lambda: probes.counter_reference(mode, xt, auxt, TIMED_ITERS, t_const), 1, 0
        )
        n_bytes = 2.0 * xt.numel() * xt.element_size() + (
            auxt.numel() * auxt.element_size() if auxt is not None else 0
        )
        elems = float(xt.numel()) * TIMED_ITERS
        if mode == "vpu":  # an FMUL and an FFMA an element
            bounds[mode] = launch_bound(n_bytes, fp32_instr=2 * elems)
        elif mode == "exp":  # an FFMA and a MUFU.EX2 an element
            bounds[mode] = launch_bound(n_bytes, fp32_instr=elems, mufu_ops=elems)
        else:
            bounds[mode] = launch_bound(n_bytes, bf16_ops=float(n) * work * TIMED_ITERS)
        print(
            f"K6 roofline_counter {mode}: {n} blocks, max_abs_err {errs[mode]:.3e} "
            f"({share:.2f} of tolerance) after {CHECK_ITERS} iterations; {note}; {TIMED_ITERS} iterations: {ms[mode]:.4f} ms "
            f"kernel ({ms[mode] * 1e3 / TIMED_ITERS:.4f} us per iteration; bound "
            f"{bounds[mode][0]:.4f} ms), {plain_ms[mode]:.3f} ms plain",
            flush=True,
        )
    return kernel_entry("roofline_counter", "baselines/roofline.py:253", errs, ms, plain_ms,
                        bounds)


def check_probe(device) -> dict:
    """K7, each mode: the check after one iteration from the tool's
    seeded a and W and a b far from the exp chain's fixed point, the
    planted faults (each chain one step short), and one launch of
    TIMED_PROBE_ITERS iterations."""
    n = probes.probe_blocks()
    t = overlap_tool.probe_inputs(n, device, seed=3, n_chunks=1)
    a, w = t["a"], t["w"]
    # b <- exp(-|b|) + 1e-3 contracts by about 0.57 a step towards 0.568;
    # from |b| in [3, 6] its 16th step is still ~1e-4 from its 15th,
    # far above FP32_RTOL, so one iteration's output shows its step count
    rng = np.random.default_rng(3)
    mag = rng.uniform(3.0, 6.0, (n, *probes.EXP_SHAPE)) * rng.choice([-1.0, 1.0], (n, *probes.EXP_SHAPE))
    b = torch.from_numpy(mag).float().to(device)
    b_short = b
    for _ in range(probes.EXP_CALLS - 1):
        b_short = probes.abs_exp_step(b_short)
    errs, ms, plain_ms, bounds = {}, {}, {}, {}
    for mode in probes.PROBE_MODES:
        ka, kb = probes.probe_overlap(mode, a, w, b, 1)
        ra, rb = probes.probe_reference(mode, a, w, b, 1)
        torch.cuda.synchronize()
        (err_a, share_a), (err_b, share_b) = probe_err(ka, ra), probe_err(kb, rb)
        errs[mode], share = max(err_a, err_b), max(share_a, share_b)
        faults = {}
        if mode != "vpu":
            faults["product chain one step short"] = (ka, a)
        if mode != "mxu":
            faults["exp chain one step short"] = (kb, b_short)
        note = planted(faults)
        ms[mode] = cuda_ms(lambda: probes.probe_overlap(mode, a, w, b, TIMED_PROBE_ITERS), 3)
        plain_ms[mode] = cuda_ms(
            lambda: probes.probe_reference(mode, a, w, b, TIMED_PROBE_ITERS), 1, 0
        )
        n_bytes = 2.0 * (a.numel() * 2 + b.numel() * 4) + w.numel() * 2
        products = float(n) * 2 * probes.CHAIN_ROWS * probes.CHAIN_W**2 * TIMED_PROBE_ITERS
        exps = float(b.numel()) * probes.EXP_CALLS * TIMED_PROBE_ITERS
        # an exp step is an FMUL, a MUFU.EX2 and an FADD an element
        bounds[mode] = launch_bound(
            n_bytes,
            bf16_ops=products if mode != "vpu" else 0.0,
            fp32_instr=2 * exps if mode != "mxu" else 0.0,
            mufu_ops=exps if mode != "mxu" else 0.0,
        )
        print(
            f"K7 probe_overlap {mode}: {n} blocks, max_abs_err {errs[mode]:.3e} "
            f"({share:.2f} of tolerance) after 1 iteration; {note}; {TIMED_PROBE_ITERS} iterations: {ms[mode]:.4f} ms kernel "
            f"(bound {bounds[mode][0]:.4f} ms), {plain_ms[mode]:.3f} ms plain",
            flush=True,
        )
    return kernel_entry("probe_overlap", "baselines/probe_overlap.py:97", errs, ms, plain_ms,
                        bounds)


def check_ctl(device) -> dict:
    """K8, each mode: the check after 3 steps of 2 products each at
    scale 1.25 (so that a lost or repeated scaling shows), the planted
    fault (the plain version one step short), and one launch of
    TIMED_CTL_STEPS steps of CTL_DOTS products."""
    n = probes.ctl_blocks()
    t = overlap_tool.probe_inputs(n, device, seed=5)
    x, a, w = t["x"], t["a"], t["w"]
    chunk = float(x[0].numel())
    errs, ms, plain_ms, bounds = {}, {}, {}, {}
    for mode in probes.CTL_MODES:
        ky, ka = probes.probe_overlap_ctl(mode, x, torch.zeros_like(x), a, w, 3, 2, 1.25)
        ry, ra = probes.ctl_reference(mode, x, torch.zeros_like(x), a, w, 3, 2, 1.25)
        torch.cuda.synchronize()
        (err_y, share_y), (err_a, share_a) = probe_err(ky, ry), probe_err(ka, ra)
        errs[mode], share = max(err_y, err_a), max(share_y, share_a)
        del ry, ra
        sy, sa = probes.ctl_reference(mode, x, torch.zeros_like(x), a, w, 2, 2, 1.25)
        n_out = outside(ky, sy) + outside(ka, sa)
        assert n_out > 0, (mode, "planted fault passes: one step short")
        del ky, ka, sy, sa
        y = torch.zeros_like(x)
        args = (mode, x, y, a, w, TIMED_CTL_STEPS, CTL_DOTS, overlap_tool.CTL_SCALE)
        ms[mode] = cuda_ms(lambda: probes.probe_overlap_ctl(*args), 3)
        plain_ms[mode] = cuda_ms(lambda: probes.ctl_reference(*args), 1, 0)
        streamed = TIMED_CTL_STEPS if mode != "ctl_mxu" else 1
        # each step scales a chunk (an FMUL an element)
        bounds[mode] = launch_bound(
            2.0 * n * streamed * chunk * 4 + 2.0 * a.numel() * 2 + w.numel() * 2,
            bf16_ops=(float(n) * 2 * probes.CHAIN_ROWS * probes.CHAIN_W**2
                      * TIMED_CTL_STEPS * CTL_DOTS) if mode != "ctl_dma" else 0.0,
            fp32_instr=float(n) * chunk * TIMED_CTL_STEPS,
        )
        print(
            f"K8 probe_overlap_ctl {mode}: {n} blocks, max_abs_err {errs[mode]:.3e} "
            f"({share:.2f} of tolerance) after 3 steps; planted fault (one step short) puts {n_out} entries outside; "
            f"{TIMED_CTL_STEPS} steps of {CTL_DOTS} product(s): {ms[mode]:.4f} ms kernel "
            f"({ms[mode] * 1e3 / TIMED_CTL_STEPS:.3f} us per step; bound "
            f"{bounds[mode][0]:.4f} ms), {plain_ms[mode]:.3f} ms plain",
            flush=True,
        )
    return kernel_entry("probe_overlap_ctl", "baselines/probe_overlap.py:194", errs, ms,
                        plain_ms, bounds)


def check_tools(device) -> dict:
    """The measurement slice's main path, with the launch counts at 0
    just before it: the roofline tool's short rate pass and the overlap
    probe at a short length.  Every rate within (0, 105%] of its
    published ceiling; the control must read OVERLAPS."""
    probes.launches.update(dict.fromkeys(probes.launches, 0))
    rates = roofline_tool.measure_rates(min_ms=2.0)
    rec = overlap_tool.run(min_ms=2.0, ctl_dots=CTL_DOTS)
    counts = dict(probes.launches)
    print(f"tools: launches {counts}", flush=True)
    for name, c in counts.items():
        assert c >= 1, (name, c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max(roofline_tool.sm_clock_mhz("clocks.max.sm"), *rates["clocks_sm_mhz"].values())
    of_ceiling = roofline_tool.check_rates(rates, roofline_tool.rate_ceilings(clock, sms))
    print(f"tools: short rate pass on {sms} SMs; exp ceiling at {clock:g} MHz", flush=True)
    roofline_tool.print_rates(rates, of_ceiling)
    print(
        f"tools: overlap probe us per iteration {rec['us_per_iter']}, verdict "
        f"{rec['verdict']} (fraction {rec['overlap_fraction']}); control us per step "
        f"{rec['control_us_per_step']} (ctl_dots {rec['ctl_dots']}), verdict "
        f"{rec['control_verdict']} (fraction {rec['control_overlap_fraction']}); clocks.sm "
        f"{rec['clocks_sm_mhz_before']:g} -> {rec['clocks_sm_mhz_after']:g} MHz",
        flush=True,
    )
    assert rec["control_verdict"] == "OVERLAPS", rec
    return counts


def check_hopper_sass(reports: dict,
                      names=("flash_fwd", "geglu_ff", "flash_bwd", "flash_bwd_dkv")) -> None:
    """K1, K5, K2 and K3b are built from wgmma and TMA: their SASS holds
    HGMMA and UTMALDG and no HMMA (mma.sync), and ptxas reports no
    spills and did not serialise the wgmma pipeline (a C75xx warning: a
    wait after every HGMMA); K2 also holds UTMAREDG, the TMA reduce-add
    of its dq partials."""
    tool = sass_counts.cuobjdump_path()
    for name in names:
        sass = subprocess.run([tool, "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        for fn, c in sass_counts.count(sass).items():
            print(f"  {name} SASS: HGMMA {c['HGMMA']} (waits {c['WGWAIT']}), UTMALDG "
                  f"{c['UTMALDG']}, UTMAREDG {c['UTMAREDG']}, HMMA {c['HMMA']}, MUFU.EX2 "
                  f"{c['MUFU.EX2']}, {c['lines']} lines", flush=True)
            assert c["HGMMA"] > 0 and c["UTMALDG"] > 0 and c["HMMA"] == 0, (name, c)
            assert c["UTMAREDG"] > 0 or name != "flash_bwd", (name, c)
        spills = [line for line in reports[name].splitlines() if "spill" in line]
        assert spills and all("0 bytes spill stores, 0 bytes spill loads" in line
                              for line in spills), (name, spills)
        serialised = [line for line in reports[name].splitlines() if "are serialized" in line]
        assert not serialised, (name, serialised)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(host_description(), flush=True)
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"mca_tpu_torch {mca_tpu_torch.__version__}",
        flush=True,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"built {', '.join(_build.KERNELS)} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C75" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    check_hopper_sass(reports)

    device = torch.device("cuda")
    kernels = [check_flash(device), check_ff(device), *check_flash_bwd(device)]
    config = training_config(str(CONFIG))
    counts = check_slice(config, device)
    counts.update(check_train(config, device))
    t7 = time.perf_counter()
    kernels += [check_counter(device), check_probe(device), check_ctl(device)]
    counts.update(check_tools(device))
    print(f"measurement slice: {time.perf_counter() - t7:.1f} s", flush=True)
    for entry in kernels:
        entry["launches"] = counts[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
