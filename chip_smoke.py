#!/usr/bin/env python3
"""Drive the PyTorch port (``mca_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each asserted; any failure exits non-zero):

1. require a CUDA device; print the card's name and power limit
   (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``);
   build every kernel from ``mca_tpu_torch/csrc`` (one ``nvcc`` each, in
   parallel).
2. K1, the flash-attention forward, against its plain version at
   TCGA_config1 shapes (B 8, H 8, T 2548, D 64, bf16, the real MCA
   mask, ragged key padding and a missing modality): live rows within
   bf16 tolerance, dead rows exactly 0.  Times: kernel, plain version,
   and ``F.scaled_dot_product_attention`` with the same mask as a
   yardstick (the port never calls it).
3. K5, the fused GEGLU feed-forward, against its plain version at
   N = 20384, D 512, inner 1365, bf16; the yardstick is the
   matmul -> gelu -> matmul chain.
4. the slice: ``EmbeddingService`` at TCGA_config1 width (dim 512,
   depth 5, 8 x 64 heads, T 2548, bf16, max_batch 8) on the GPU with
   weights from a fixed seed answers ``embed`` (20 rows, three
   pipelined chunks), ``submit`` from several threads and ``POST
   /embed`` over localhost HTTP; the three agree; each kernel launched
   5 times per forward; the embeddings agree with the same weights run
   in fp32 on the CPU through the plain versions.
5. one ``{"kernels": [...]}`` line, then the last line
   ``{"ok": true, "device": {...}}``.

Bounds use the H100 SXM's published peaks (989 TFLOP/s dense bf16,
3.35 TB/s HBM3); the card's power limit is printed beside them.
"""

from __future__ import annotations

import json
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
from mca_tpu_torch.config import training_config
from mca_tpu_torch.data.synthetic import tabular_rows
from mca_tpu_torch.masks import build_masks
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops import fused_ff as ff
from mca_tpu_torch.serve import EmbeddingService, make_server

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "tcga_mca.yaml"
PEAK_BF16 = 989e12  # FLOP/s, dense
PEAK_BYTES = 3.35e12  # bytes/s
# bf16 results: two units in the last place relative, plus an absolute
# floor for values near zero where the operands' own rounding dominates
BF16_RTOL = 2.0**-6
FLASH_ATOL = 4e-3  # p is rounded to bf16 against different running maxima
FF_ATOL = 1e-3
# embeddings, bf16 on the GPU vs fp32 on the CPU: relative L2 gap per key
# (bf16 rounds each activation to 8 significant bits, ~2e-3 relative;
# the final fp32 norm and pool average much of it out)
SLICE_REL_L2 = 1e-2
AGREE_ATOL = 1e-3  # embed vs submit vs HTTP: same kernels, batch-mates differ


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
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def bf16_err(kernel: torch.Tensor, plain: torch.Tensor, atol: float) -> float:
    """Max |kernel - plain|; asserts it is within bf16 tolerance."""
    k, p = kernel.float(), plain.float()
    diff = (k - p).abs()
    bad = diff > atol + BF16_RTOL * p.abs()
    assert not bool(bad.any()), (
        f"{int(bad.sum())} entries outside tolerance, max abs err "
        f"{float(diff.max())}"
    )
    return float(diff.max())


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


def check_flash(device) -> dict:
    mask, q, k, v, pad = flash_inputs(device)
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
        f"bound {bms:.4f} ms ({by}), {pairs:.4g} live score entries",
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


def check_ff(device, n=20384, dim=512, inner=1365, seed=0) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, dim), generator=g, device=device).to(torch.bfloat16)
    w1 = ((torch.rand((dim, 2 * inner), generator=g, device=device) * 2 - 1)
          * dim**-0.5).to(torch.bfloat16)
    w2 = ((torch.rand((inner, dim), generator=g, device=device) * 2 - 1)
          * inner**-0.5).to(torch.bfloat16)
    prepared = ff.prepare_geglu_weights(w1, w2, torch.bfloat16)
    with torch.inference_mode():
        out = ff.geglu_ff(x, *prepared)
        ref = ff.geglu_ff_reference(x, w1, w2)
        torch.cuda.synchronize()
        err = bf16_err(out, ref, FF_ATOL)

        def chain():
            u, gate = (x @ w1).chunk(2, dim=-1)
            return (torch.nn.functional.gelu(gate) * u) @ w2

        ms = cuda_ms(lambda: ff.geglu_ff(x, *prepared), 20)
        plain_ms = cuda_ms(lambda: ff.geglu_ff_reference(x, w1, w2), 5)
        lib_ms = cuda_ms(chain, 20)
    n_ops = 6.0 * n * dim * inner
    n_bytes = 2.0 * (x.numel() + w1.numel() + w2.numel() + out.numel())
    bms, by = bound_ms(n_bytes, n_ops)
    print(
        f"K5 geglu_ff: max_abs_err {err:.3e}, {ms:.4f} ms kernel, "
        f"{plain_ms:.4f} ms plain, {lib_ms:.4f} ms matmul-gelu-matmul, "
        f"bound {bms:.4f} ms ({by})",
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
        "library_ms": lib_ms,
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
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
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    device = torch.device("cuda")
    kernels = [check_flash(device), check_ff(device)]
    counts = check_slice(training_config(str(CONFIG)), device)
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
