"""Speed-of-light (roofline) analysis of the port's training step on the GPU.

    python -m mca_tpu_torch.tools.roofline [--dataset tcga|cmu] \\
        [--variant zorro] [--k 16] [--out results.jsonl]

The port of ``baselines/roofline.py``.  For each hot component it

1. COUNTS the work from the port's own tile schedule (the CSR
   ``tile_schedule`` / ``pair_schedule`` / ``kv_pair_schedule`` of
   ``ops/flash_attention.py``
   at 64 x 64 tiles, one launch per layer: the JAX package's row bands
   do not apply) on the real MCA / zorro / CMU mask: tensor-core flops,
   elementwise and exp element counts, and device-memory bytes;
2. MEASURES the card's achievable rates with the K6 microkernel
   (``csrc/roofline_counter.cu``) at the flash kernels' own tile
   dataflow, fp32 and exp sweeps, and an in-place PyTorch add over 256 MB
   fp32 (five times the 50 MB L2) for device memory;
3. REPORTS measured time against two bounds per component: ``light_ms``
   (the units overlap) and ``serial_ms`` (the tensor-core and elementwise
   time add, device-memory time still overlaps), with ``x_of_light`` and
   ``x_of_serial``.

The counting functions are pure numpy (``tests/test_torch_roofline.py``
holds them to the JAX ones); the measuring half needs a CUDA device and
raises without one.  Every rate is printed with the SM clock that
``nvidia-smi`` reads just after it, and checked against its ceiling
(:func:`rate_ceilings`): a rate above 105% of it means a broken
instrument.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from mca_tpu_torch.config import get_model_config, training_config
from mca_tpu_torch.masks import build_masks
from mca_tpu_torch.ops import probes
from mca_tpu_torch.ops.flash_attention import (
    BLOCK,
    flash_attention,
    kv_pair_schedule,
    pair_schedule,
    tile_schedule,
)

ROOT = Path(__file__).resolve().parents[2]
CONFIG = ROOT / "configs" / "tcga_mca.yaml"

# H100 SXM published peaks (dense), the lines each rate is read against
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
MUFU_PER_CLOCK_PER_SM = 16
RATE_SLACK = 1.05

# CMU-MOSEI token shapes (input size, tokens), as baselines/roofline.py
CMU_SHAPES = {
    "COVAREP": (74, 1500),
    "FACET": (35, 450),
    "OpenFace": (713, 450),
    "glove_vectors": (300, 50),
}


# ---------------------------------------------------------------------------
# Counting (pure numpy)
# ---------------------------------------------------------------------------


def attention_counts(attn_mask, *, batch, heads, dim_head, io_bytes=2):
    """Count one layer's work in the port's flash kernels: K1 forward
    (``fwd``) and K2, the fused backward (``bwd``).

    Returns ``{"fwd": {...}, "bwd": {...}}`` with ``mxu_flops`` (2·M·N·K),
    ``vpu_elems`` and ``exp_elems`` as ``baselines/roofline.py`` counts them
    (per visited tile 2 products, 7 sweeps and 1 exp sweep forward; 5, 9
    and 1 backward), ``mxu_by_shape`` (``fwdpair:64x64x64``,
    ``bwd5:64x64x64``), ``hbm_bytes`` and its parts ``hbm_terms``.  On a
    square mask the products and element counts equal the JAX count with
    one band ``(0, T, 0, T, 64, 64)``.  The bytes follow the port's
    kernels (all times batch x heads; n tiles visited, m of them not
    full, T rows), and differ from the JAX count where the kernels do:

    - K1 reads q and writes out and lse once per row, ``T (2 d b + 4)``
      with ``b`` = ``io_bytes`` (JAX: per q run of 64 rows, the ragged
      last tile counted whole);
    - K1 walks q tiles in pairs (``pair_schedule``) and loads each k and
      v tile once for both halves of a pair, ``p 2 64 d b`` for the p
      visited (pair, kv tile) items (JAX: per visited tile), and reads a
      tile that is not full as 64 rows of 64 bits, 512 bytes (JAX: the
      64 x 64 mask bytes);
    - K2 walks kv tiles in pairs (``kv_pair_schedule``): it reads k and
      v once per kv tile, ``2 T d b`` (JAX: per visited tile), and q, do,
      lse and delta once per (pair of kv tiles, q tile) item, ``p' (2 64
      d b + 64 8)`` for the p' items (JAX: per visited tile); it reads
      the key padding once per key, ``T`` (JAX: per tile), and a tile
      that is not full as 64 rows of 64 bits, 512 bytes (JAX: the 64 x
      64 mask bytes);
    - K2 adds each visited tile's fp32 dq partial into an fp32 buffer
      with a TMA reduce-add, ``64 n d 4`` (JAX: one fp32 flush of the T
      rows), and writes dk and dv once, ``2 T d b`` (JAX: per kv run of
      64 rows).

    K1's key padding (64 bytes a tile) is counted per visited tile, as in
    the JAX count.
    """
    attn_mask = np.asarray(attn_mask, bool)
    t = attn_mask.shape[0]
    _, col_idx, full = tile_schedule(attn_mask)
    n_pair_items = len(pair_schedule(attn_mask)[1])
    n_kv_pair_items = len(kv_pair_schedule(attn_mask)[1])
    bh, d, bl = batch * heads, dim_head, BLOCK
    n_tiles = len(col_idx)
    n_masked = int((full == 0).sum())
    entries = n_tiles * bl * bl
    tile_flops = float(bh * n_tiles * 2 * bl * bl * d)  # one product's worth
    fwd_terms = {
        "k_v_tiles": n_pair_items * 2 * bl * d * io_bytes,
        "q": t * d * io_bytes,
        "out_lse": t * (d * io_bytes + 4),
        "mask_bits": n_masked * bl * 8,
        "key_padding": n_tiles * bl,
    }
    bwd_terms = {
        "k_v": t * 2 * d * io_bytes,
        "q_do_items": n_kv_pair_items * 2 * bl * d * io_bytes,
        "lse_delta_items": n_kv_pair_items * bl * 8,
        "dq_reduce": n_tiles * bl * d * 4,
        "dk_dv": t * 2 * d * io_bytes,
        "mask_bits": n_masked * bl * 8,
        "key_padding": t,
    }

    def direction(shape, products, sweeps, terms):
        flops = products * tile_flops
        return {
            "mxu_flops": flops,
            "vpu_elems": float(bh * entries * sweeps),
            "exp_elems": float(bh * entries),
            "hbm_bytes": float(bh * sum(terms.values())),
            "mxu_by_shape": {f"{shape}:{bl}x{d}x{bl}": flops},
            "hbm_terms": {k: float(bh * v) for k, v in terms.items()},
        }

    return {
        "fwd": direction("fwdpair", 2, 7, fwd_terms),
        "bwd": direction("bwd5", 5, 9, bwd_terms),
    }


def gemm_flops(cfg_like, seq_len):
    """Non-attention tensor-core flops for one forward pass: QKV/out
    projections, GEGLU FF, value encoders (as ``baselines/roofline.py``)."""
    D = cfg_like["dim"]
    B = cfg_like["batch"]
    depth = cfg_like["depth"]
    H, dh = cfg_like["heads"], cfg_like["dim_head"]
    inner = int(D * cfg_like["ff_mult"] * 2 / 3)
    T = seq_len
    proj = 2 * B * T * D * (H * dh * 4)
    ff = 2 * B * T * (D * 2 * inner + inner * D)
    enc = 2 * B * cfg_like["enc_tokens"] * D * (D + 2)
    return depth * (proj + ff) + enc


def optimizer_bytes(n_params, moment_bytes=4):
    """Flat fused AdamW device-memory traffic per step: read
    params+m+v+grads, write params+m+v (fp32; bf16 moments halve m/v)."""
    return n_params * (4 * 2 + 4 + 2 * 2 * moment_bytes)


def light_ms(counts, rates):
    """Light-speed time (ms) of a counted component: the max over the
    three units at their measured rates, each product shape at its own
    rate where the rates have it; ``serial_ms`` adds the tensor-core and
    elementwise times (device memory still overlaps)."""
    shape_rates = rates.get("mxu_shape_rates", {})
    by_shape = counts.get("mxu_by_shape") or {}
    if by_shape and all(k in shape_rates for k in by_shape):
        t_mxu = sum(f / shape_rates[k] for k, f in by_shape.items())
    else:
        t_mxu = counts["mxu_flops"] / rates["mxu_flops_s"]
    t_vpu = (
        counts["vpu_elems"] / rates["vpu_elems_s"]
        + counts["exp_elems"] / rates["exp_elems_s"]
    )
    t_hbm = counts["hbm_bytes"] / rates["hbm_bytes_s"]
    return {
        "mxu_ms": t_mxu * 1e3,
        "vpu_ms": t_vpu * 1e3,
        "hbm_ms": t_hbm * 1e3,
        "light_ms": max(t_mxu, t_vpu, t_hbm) * 1e3,
        "serial_ms": max(t_mxu + t_vpu, t_hbm) * 1e3,
        "bound": max(
            ("mxu", t_mxu), ("vpu", t_vpu), ("hbm", t_hbm),
            key=lambda kv: kv[1],
        )[0],
    }


def embedded_sequence_params(input_size: int, dim: int) -> int:
    """Parameters of the JAX package's ``EmbeddedSequenceEncoder``, which
    the port has not ported: pre-LayerNorm (2 x input), the projection
    (input x dim + dim) and post-LayerNorm (2 x dim); its positional
    encoding is sinusoidal."""
    return 2 * input_size + input_size * dim + dim + 2 * dim


def count_params(cfg) -> int:
    """Parameters of the port's model for ``cfg``.  The CMU encoders are
    not ported: the trunk is built with tabular stand-ins of the same
    token counts, which are left out of the count, and the encoders are
    counted by :func:`embedded_sequence_params`."""
    from mca_tpu_torch.models import build_model

    mc = get_model_config(cfg)
    encoders = mc["encoder_configs"]
    unported = {
        m: e for m, e in encoders.items() if e["type"] == "EmbeddedSequenceEncoder"
    }
    if unported:
        mc = dict(mc, encoder_configs={
            m: {"type": "TabularEncoder", "num_embeddings": int(e["max_tokens"]),
                "max_tokens": int(e["max_tokens"])}
            for m, e in encoders.items()
        })
    model = build_model(mc, fused_ff=False)
    n = sum(
        p.numel() for name, p in model.named_parameters()
        if not (unported and name.startswith("encoders."))
    )
    return int(n + sum(
        embedded_sequence_params(int(e["input_size"]), int(mc["dim"]))
        for e in unported.values()
    ))


def build_case(dataset="tcga", variant=""):
    """Real mask and model shape of a canonical config, from
    ``configs/tcga_mca.yaml`` (TCGA_config1) with the overrides of
    ``baselines/roofline.py``'s ``build_case``; ``n_params`` is counted
    from the port's model (:func:`count_params`)."""
    cfg = training_config(str(CONFIG))
    if variant == "zorro":
        cfg.zorro = True
    if dataset == "cmu":
        cfg.encoder_configs = {
            m: {"type": "EmbeddedSequenceEncoder", "input_size": di, "max_tokens": ti}
            for m, (di, ti) in CMU_SHAPES.items()
        }
        cfg.modality_config = {
            m: {"type": "embedded_sequence", "pad_len": ti, "data_col_name": "data",
                "pad_token": -10000, "embedding_size": di}
            for m, (di, ti) in CMU_SHAPES.items()
        }
        cfg.bimodal_contrastive = False
        cfg.non_fusion_fcl = False
    mc = get_model_config(cfg)
    token_dims = [int(e["max_tokens"]) for e in mc["encoder_configs"].values()]
    ms = build_masks(
        token_dims, int(cfg.num_fusion_tokens), list(cfg.fusion_combos),
        zorro=bool(cfg.zorro), fcl=bool(cfg.get("fcl", False)),
        no_fusion=bool(cfg.get("no_fusion", False)),
    )
    return {
        "attn_mask": np.asarray(ms.attn_mask, bool),
        "cfg_like": {
            "dim": mc["dim"], "depth": mc["depth"], "heads": mc["heads"],
            "dim_head": mc["dim_head"], "ff_mult": mc["ff_mult"],
            "batch": cfg.batch_size, "enc_tokens": sum(token_dims),
        },
        "seq_len": ms.seq_len,
        "n_params": count_params(cfg),
    }


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


def smi(fields: str) -> str:
    """One ``nvidia-smi --query-gpu`` line for the first card."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def sm_clock_mhz(field: str = "clocks.sm") -> float:
    return float(smi(f"{field}").split()[0])


def require_cuda(tool: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} measures the GPU and needs a CUDA device")


def rate_ceilings(clock_mhz: float, sms: int) -> Dict[str, float]:
    """The published ceiling each measured rate is read against: the
    dense bf16 peak for the tensor-core rates, the fp32 peak for the
    elementwise rate, 16 MUFU operations a clock per SM at ``clock_mhz``
    for exp, and the HBM3 rate for device memory."""
    return {
        "mxu": PEAK_BF16,
        "mxu_big_flops_s": PEAK_BF16,
        "vpu_elems_s": PEAK_FP32,
        "exp_elems_s": MUFU_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6,
        "hbm_bytes_s": PEAK_BYTES,
    }


def check_rates(rates, ceilings) -> Dict[str, float]:
    """Each rate as a fraction of its ceiling; raises if one is not
    positive or exceeds its ceiling by more than 5%."""
    named = {f"mxu_shape_rates[{k}]": (v, ceilings["mxu"])
             for k, v in rates["mxu_shape_rates"].items()}
    for key in ("mxu_big_flops_s", "vpu_elems_s", "exp_elems_s", "hbm_bytes_s"):
        named[key] = (rates[key], ceilings[key])
    frac = {k: v / c for k, (v, c) in named.items()}
    bad = {k: f for k, f in frac.items() if not 0 < f <= RATE_SLACK}
    if bad:
        raise RuntimeError(f"rates outside (0, {RATE_SLACK}] of their ceilings: {bad}")
    return frac


# ---------------------------------------------------------------------------
# Measuring (CUDA)
# ---------------------------------------------------------------------------


def cuda_ms(fn: Callable[[], object], reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def per_iteration_s(launch: Callable[[int], object], iters: int, min_ms: float,
                    reps: int = 3) -> Tuple[float, dict]:
    """Seconds per loop iteration of ``launch(n)``: the time of ``iters``
    iterations minus that of ``iters // 2``, over the difference in
    iterations.  Each is the least of ``reps`` single launches, taken in
    turns (full, half, full, ...), so that a slow launch of either does
    not move the difference; ``iters`` grows fourfold until the full
    launch takes ``min_ms`` and 1.2x the half one, so that the difference
    is the loop and not the launch.  (The TPU tool also perturbed each
    launch with a counter, because its remote relay returned cached
    results for identical launches; nothing caches a CUDA launch, so the
    port has no counter.)  Returns ``(seconds, {"iters", "full_ms",
    "half_ms"})``."""
    for _ in range(8):
        launch(iters)  # warm-up
        full, half = [], []
        for _ in range(reps):
            full.append(cuda_ms(lambda: launch(iters), 1, warmup=0))
            half.append(cuda_ms(lambda: launch(iters // 2), 1, warmup=0))
        t_full, t_half = min(full), min(half)
        if t_full > 1.2 * t_half and t_full > min_ms:
            break
        iters *= 4
    used = {"iters": iters, "full_ms": t_full, "half_ms": t_half}
    return (t_full - t_half) / (iters - iters // 2) / 1e3, used


def counter_inputs(mode: str, n_blocks: int, device, fill: float):
    """Constant inputs of K6's ``mode`` for ``n_blocks`` blocks, as the
    TPU tool filled them."""
    tile, dtype, aux_shape = probes.counter_shapes(mode)
    x0 = torch.full((n_blocks, *tile), fill, dtype=dtype, device=device)
    aux = torch.full(aux_shape, 0.01, dtype=torch.bfloat16, device=device) if aux_shape else None
    return x0, aux


# per mode: (tensor-core flops or elementwise ops a block and iteration,
# the body's constant as the TPU tool set it at counter 0, initial fill)
COUNTER_WORK = {
    "fwdpair": (4 * 64 * 64 * 64, 1e-4, 0.01),
    "bwd5": (10 * 64 * 64 * 64, 1e-4, 0.01),
    "big": (2 * 128 * 256 * 256, 1e-4 / 256, 0.01),
    "vpu": (3 * 4096, 0.5, 0.5),
    "exp": (4096, 0.0, 0.5),
}


def measure_rates(min_ms: float = 20.0) -> dict:
    """Achievable rates on this card, from K6 launched on as many blocks
    as reside at once (each block its own chain; no device memory in the
    loop):

    - ``mxu_shape_rates["fwdpair:64x64x64"]`` and ``["bwd5:64x64x64"]``:
      K1's and K2's tile dataflows (wgmma m64n64k16, 64-deep products,
      64 rows a warpgroup);
    - ``mxu_big_flops_s``: the 256-deep chained product (wgmma
      m64n256k16);
    - ``vpu_elems_s``: fp32 ``x - c x x`` (3 operations an element);
    - ``exp_elems_s``: fp32 exp;
    - ``hbm_bytes_s``: an in-place add over 256 MB of fp32, read + write.

    ``clocks_sm_mhz`` holds the SM clock read after each rate.
    """
    dev = torch.device("cuda")
    rates: dict = {"mxu_shape_rates": {}, "clocks_sm_mhz": {}, "iters": {}}
    for mode, (work, const, fill) in COUNTER_WORK.items():
        n = probes.counter_blocks(mode)
        x0, aux = counter_inputs(mode, n, dev, fill)
        dt, used = per_iteration_s(
            lambda it: probes.roofline_counter(mode, x0, aux, it, const), 256, min_ms
        )
        rate = n * work / dt
        key = {"vpu": "vpu_elems_s", "exp": "exp_elems_s", "big": "mxu_big_flops_s"}.get(mode)
        if key is None:
            key = f"{mode}:64x64x64"
            rates["mxu_shape_rates"][key] = rate
        else:
            rates[key] = rate
        rates["clocks_sm_mhz"][key] = sm_clock_mhz()
        rates["iters"][key] = {**used, "blocks": n, "s_per_iter": dt}
    rates["mxu_flops_s"] = min(rates["mxu_shape_rates"].values())

    h = torch.zeros((64, 1024, 1024), dtype=torch.float32, device=dev)  # 256 MB
    dt, used = per_iteration_s(
        lambda n: [h.add_(1.0) for _ in range(n)], 8, min_ms
    )
    rates["hbm_bytes_s"] = 2 * h.numel() * 4 / dt
    rates["clocks_sm_mhz"]["hbm_bytes_s"] = sm_clock_mhz()
    rates["iters"]["hbm_bytes_s"] = {**used, "s_per_iter": dt}
    del h
    return rates


def measure_attention(attn_mask, *, batch, heads, dim_head, k=48, seed=0):
    """Milliseconds of one layer's attention through the port's kernels,
    at the model's shapes with no key padding, as the TPU tool timed it:
    ``flash_attention`` forward (K1), and forward + backward (K1, K2) of
    q = k = v, each a mean over ``k`` calls (CUDA events)."""
    dev = torch.device("cuda")
    t = attn_mask.shape[0]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = (torch.randn((batch, heads, t, dim_head), generator=g, device=dev) * 0.1).to(
        torch.bfloat16
    )
    pad = torch.zeros((batch, t), dtype=torch.bool, device=dev)
    scale = dim_head**-0.5
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: flash_attention(q, q, q, attn_mask, pad, scale), k)
    x = q.clone().requires_grad_(True)
    ones = torch.ones_like(q)

    def fwd_bwd():
        out = flash_attention(x, x, x, attn_mask, pad, scale)[0]
        return torch.autograd.grad(out, x, ones)

    fb_ms = cuda_ms(fwd_bwd, k)
    return {"fwd_ms": fwd_ms, "fwd_bwd_ms": fb_ms, "bwd_ms": fb_ms - fwd_ms}


def print_rates(rates: dict, of_ceiling: dict) -> None:
    for key, mhz in rates["clocks_sm_mhz"].items():
        frac = of_ceiling.get(key, of_ceiling.get(f"mxu_shape_rates[{key}]"))
        rate = rates["mxu_shape_rates"].get(key, rates.get(key))
        print(f"  rate {key} = {rate / 1e12:.4f} T/s, {frac:.4f} of its "
              f"ceiling, at clocks.sm {mhz:g} MHz", flush=True)


def _rounded(d):
    return {k: round(v, 3) if isinstance(v, float) else v for k, v in d.items()}


def report(dataset: str = "tcga", variant: str = "", k: int = 16) -> dict:
    """The full report: card, rates and their ceilings, and the rows of
    measured against light-speed time."""
    require_cuda("the roofline tool")
    card = smi("name,power.limit")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_before = sm_clock_mhz()
    case = build_case(dataset, variant)
    cl = case["cfg_like"]
    rates = measure_rates()
    clock_after = sm_clock_mhz()
    clock_max = sm_clock_mhz("clocks.max.sm")
    ceilings = rate_ceilings(max(clock_max, *rates["clocks_sm_mhz"].values()), sms)
    of_ceiling = check_rates(rates, ceilings)

    counts = attention_counts(
        case["attn_mask"], batch=cl["batch"], heads=cl["heads"], dim_head=cl["dim_head"]
    )
    depth = cl["depth"]
    meas = measure_attention(
        case["attn_mask"], batch=cl["batch"], heads=cl["heads"],
        dim_head=cl["dim_head"], k=max(16, 3 * k),
    )
    rows = []
    for dirn, measured in (("fwd", meas["fwd_ms"]), ("bwd", meas["bwd_ms"])):
        for per, mult in (("layer", 1), ("step", depth)):
            c = {
                k2: ({kk: vv * mult for kk, vv in v2.items()} if isinstance(v2, dict) else v2 * mult)
                for k2, v2 in counts[dirn].items()
            }
            ls = light_ms(c, rates)
            rows.append({
                "component": f"attention_{dirn}_per_{per}",
                "measured_ms": round(measured * mult, 4),
                **_rounded(ls),
                "x_of_light": round(measured * mult / ls["light_ms"], 2),
                "x_of_serial": round(measured * mult / ls["serial_ms"], 2),
            })
    gf = gemm_flops(cl, case["seq_len"])
    rows.append({
        "component": "proj+ff+enc GEMMs fwd per step",
        "light_ms": round(gf / rates["mxu_big_flops_s"] * 1e3, 3), "bound": "mxu",
        "note": "bwd = 2x; deep contractions at the 256-deep chained rate",
    })
    ob = optimizer_bytes(case["n_params"])
    rows.append({
        "component": "optimizer (flat AdamW) per step",
        "light_ms": round(ob / rates["hbm_bytes_s"] * 1e3, 3), "bound": "hbm",
    })
    t = case["seq_len"]
    return {
        "dataset": dataset, "variant": variant,
        "device": torch.cuda.get_device_name(0),
        "rates": rates,
        "rates_of_ceiling": of_ceiling,
        "spec": {
            "card": card, "sms": sms,
            "bf16_peak_flops_s": PEAK_BF16, "fp32_peak_flops_s": PEAK_FP32,
            "hbm_spec_gbs": PEAK_BYTES / 1e9, "ceilings": ceilings,
            "clocks_sm_mhz_before": clock_before, "clocks_sm_mhz_after": clock_after,
            "clocks_max_sm_mhz": clock_max,
        },
        "bands": [[0, t, 0, t, BLOCK, BLOCK]],
        "n_params": case["n_params"],
        "attention_ms": meas,
        "rows": rows,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", default="tcga")
    ap.add_argument("--variant", default="")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    rep = report(args.dataset, args.variant, args.k)
    print(rep["spec"]["card"], flush=True)
    print_rates(rep["rates"], rep["rates_of_ceiling"])
    print(json.dumps(rep, indent=1))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rep) + "\n")
    return rep


if __name__ == "__main__":
    main()
