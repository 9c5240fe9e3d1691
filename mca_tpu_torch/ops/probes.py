"""Measurement kernels: Hopper kernels + plain versions.

The TPU kernels these replace are the three Pallas microkernels of the
JAX package's measurement tools:

- K6 ``baselines/roofline.py::_counter_kernel`` -> ``csrc/roofline_counter.cu``
  (:func:`roofline_counter`): a dependency-chained loop over one of five
  bodies, ``fwdpair``, ``bwd5``, ``big``, ``vpu``, ``exp``;
- K7 ``baselines/probe_overlap.py`` ``make_run`` -> ``csrc/probe_overlap.cu``
  (:func:`probe_overlap`): a matrix chain and an exp chain, alone or in
  one body;
- K8 ``probe_overlap.py`` ``make_ctl_run`` -> ``csrc/probe_overlap_ctl.cu``
  (:func:`probe_overlap_ctl`): a double-buffered copy stream against the
  matrix chain, the probe's positive control.

The CUDA sources' headers say what each body computes on the card and
how.  A block of the card chains its own tile, so every input and output
here has a leading block dimension; the wrappers' ``*_blocks`` functions
give the number of blocks that reside on the card at once, which the
measuring tools launch.

The plain versions (``*_reference`` and the ``*_step`` bodies they
loop) repeat the kernels' arithmetic in PyTorch: fp32 products of bf16
operands, bf16 roundings where the kernels round.  A wrapper sends CPU
tensors to the plain version, CUDA tensors to the kernel, and raises on
anything else; there is no fallback.  ``launches`` counts kernel
launches per kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from mca_tpu_torch import _build

COUNTER_MODES = ("fwdpair", "bwd5", "big", "vpu", "exp")
PROBE_MODES = ("mxu", "vpu", "both")
CTL_MODES = ("ctl_dma", "ctl_mxu", "ctl_both")

TILE = 64  # fwdpair / bwd5: a [64 x 64] bf16 q tile a block, k and v [64 x 64]
CHAIN_W = 256  # the chained product: a [128 x 256] bf16 a block, W [256 x 256]
CHAIN_ROWS = 128
EXP_CALLS = 9  # K7: exp steps per iteration (csrc/probe_overlap.cu's kExpCalls)
SWEEP_SHAPE = (64, 64)  # vpu / exp of K6: 4096 fp32 a block
EXP_SHAPE = (32, 256)  # K7's exp tile: 8192 fp32 a block
CHUNK_SHAPE = (11, 1024)  # K8's streamed chunk: 44 KB of fp32

#: kernel launches per kernel (plain-version calls excluded)
launches = {"roofline_counter": 0, "probe_overlap": 0, "probe_overlap_ctl": 0}

_BF16 = torch.bfloat16
_LOG2E = 1.4426950408889634


def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """fp32 product of (bf16) operands: the kernels' fp32 accumulation."""
    return x.float() @ y.float()


# --------------------------------------------------------------------------
# The bodies, one iteration each (the plain versions loop them)
# --------------------------------------------------------------------------


def fwdpair_step(q, k, v, eps: float):
    """``s = q k^T``, ``o = bf16(s) v``, ``q <- bf16(q + eps o)``
    (baselines/roofline.py:366-375): the forward tile's two products."""
    s = _mm(q, k.mT)
    o = _mm(s.to(_BF16), v)
    return (q.float() + o * eps).to(_BF16)


def bwd5_products(q, k, v) -> dict:
    """The backward tile's products (baselines/roofline.py:388-410), with
    ``do = q``: ``s = q k^T``, ``dp = do v^T``, ``ds = bf16(s + dp)``,
    ``dv = bf16(s)^T do``, ``dk = ds^T q``, ``dq = ds k``.  dv takes
    bf16(s) where the TPU body takes ds (see ``csrc/roofline_counter.cu``);
    it is the one difference."""
    s = _mm(q, k.mT)
    dp = _mm(q, v.mT)
    ds = (s + dp).to(_BF16)
    return {"s": s, "dp": dp, "ds": ds, "dv": _mm(s.to(_BF16).mT, q),
            "dk": _mm(ds.mT, q), "dq": _mm(ds, k)}


def bwd5_step(q, k, v, eps: float):
    """``fold`` = column sums of dv + dk, ``q <- bf16(q + eps (dq +
    fold))`` (baselines/roofline.py:411-412), from :func:`bwd5_products`."""
    p = bwd5_products(q, k, v)
    fold = (p["dv"] + p["dk"]).sum(dim=-2, keepdim=True)
    return (q.float() + (p["dq"] + fold) * eps).to(_BF16)


def big_step(a, w, scale: float):
    """``a <- bf16(a + scale (a W))`` (baselines/roofline.py:430-435, with
    its ``eps / n`` as one ``scale``)."""
    return (a.float() + _mm(a, w) * scale).to(_BF16)


def vpu_step(x, c: float):
    """``x <- x - c x x`` in fp32 (baselines/roofline.py:449-450)."""
    return x - c * x * x


def exp_step(x, eps: float):
    """``x <- exp(-x - eps)`` in fp32 (baselines/roofline.py:461-462)."""
    return torch.exp(-x - eps)


def decay_step(a, w):
    """``a <- bf16(0.999 (a W))`` (baselines/probe_overlap.py:105-111)."""
    return (_mm(a, w) * 0.999).to(_BF16)


def abs_exp_step(b):
    """``b <- exp(-|b|) + 1e-3`` in fp32 (baselines/probe_overlap.py:112)."""
    return torch.exp(-b.abs()) + 1e-3


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------


def counter_shapes(mode: str) -> Tuple[tuple, torch.dtype, Optional[tuple]]:
    """``(tile shape, dtype, aux shape)`` of one block of K6's ``mode``;
    aux is k and v stacked (fwdpair, bwd5), W (big) or None."""
    if mode in ("fwdpair", "bwd5"):
        return (TILE, TILE), _BF16, (2 * TILE, TILE)
    if mode == "big":
        return (CHAIN_ROWS, CHAIN_W), _BF16, (CHAIN_W, CHAIN_W)
    if mode in ("vpu", "exp"):
        return SWEEP_SHAPE, torch.float32, None
    raise ValueError(f"mode must be one of {COUNTER_MODES}, got {mode!r}")


def counter_reference(mode: str, x0, aux, iters: int, eps: float):
    """Plain version of K6: ``iters`` iterations of ``mode``'s body on
    each block's tile of ``x0`` ([blocks, *tile]).  ``eps`` is the body's
    one constant: eps (fwdpair, bwd5, exp), scale (big), c (vpu)."""
    counter_shapes(mode)
    x = x0
    for _ in range(iters):
        if mode == "fwdpair":
            x = fwdpair_step(x, aux[:TILE], aux[TILE:], eps)
        elif mode == "bwd5":
            x = bwd5_step(x, aux[:TILE], aux[TILE:], eps)
        elif mode == "big":
            x = big_step(x, aux, eps)
        elif mode == "vpu":
            x = vpu_step(x, eps)
        else:
            x = exp_step(x, eps)
    return x.clone() if x is x0 else x


def counter_check_inputs(mode: str, n_blocks: int, seed: int = 0):
    """Seeded CPU inputs ``(x0, aux, const)`` of K6's ``mode`` under which
    every product of the body moves the chain by several bf16 units within
    4 iterations, so that a kernel that drops or garbles one, or runs one
    iteration short, ends outside bf16 tolerance of the plain version.

    fwdpair: q ~ N(0, 1), k, v ~ N(0, 1/64), eps 0.2.  bwd5: the same q,
    k and v, but with each column's sum over the 64 keys taken out and a
    mean of +-3e-4 put back, and eps 0.015: ``fold`` (the column sums of
    dv + dk) is about 64 (2 sum(k) + sum(v)), about 1e2 with k and v left
    as drawn, where it would swamp dq (about 1); this way dq, dv and dk
    are each about the same size and each moves q.  big: a ~ N(0, 1), W
    ~ N(0, 1/256), scale 0.2.  vpu: x ~ U(0.1, 0.9), c 0.5.  exp: x ~
    U(0, 1), eps 0.01."""
    tile, dtype, aux_shape = counter_shapes(mode)
    rng = np.random.default_rng(seed)
    aux = None
    if mode in ("fwdpair", "bwd5"):
        x0 = rng.standard_normal((n_blocks, *tile))
        aux = rng.standard_normal(aux_shape) * 0.125
        const = 0.2
        if mode == "bwd5":
            for half in (aux[:TILE], aux[TILE:]):
                half -= half.mean(axis=0)
                half += 3e-4 * rng.choice([-1.0, 1.0], TILE)
            const = 0.015
    elif mode == "big":
        x0 = rng.standard_normal((n_blocks, *tile))
        aux = rng.standard_normal(aux_shape) / 16
        const = 0.2
    elif mode == "vpu":
        x0, const = rng.uniform(0.1, 0.9, (n_blocks, *tile)), 0.5
    else:
        x0, const = rng.uniform(0.0, 1.0, (n_blocks, *tile)), 0.01
    put = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    return put(x0), (put(aux).to(_BF16) if aux is not None else None), const


def probe_reference(mode: str, a, w, b, iters: int):
    """Plain version of K7 on [blocks, 128, 256] bf16 ``a`` and [blocks,
    32, 256] fp32 ``b``: per iteration, ``mxu`` one :func:`decay_step`,
    ``vpu`` EXP_CALLS :func:`abs_exp_step`, ``both`` the two."""
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {PROBE_MODES}, got {mode!r}")
    a, b = a.clone(), b.clone()
    for _ in range(iters):
        if mode in ("mxu", "both"):
            a = decay_step(a, w)
        if mode in ("vpu", "both"):
            for _ in range(EXP_CALLS):
                b = abs_exp_step(b)
    return a, b


def ctl_chunks(step: int, n_blocks: int, n_chunks: int) -> torch.Tensor:
    """The chunk of x each block streams at ``step``: block b walks its
    own ``p = n_chunks // n_blocks`` chunks, ``b p + step mod p``."""
    per = n_chunks // n_blocks
    return torch.arange(n_blocks) * per + step % per


def ctl_reference(mode: str, x, y, a, w, steps: int, dots: int, scale: float):
    """Plain version of K8, returns ``(y, a)``: ``ctl_dma`` and
    ``ctl_both`` write ``y[c] = x[c] * scale`` for every chunk ``c`` a
    block streams; ``ctl_mxu`` scales each block's first chunk ``steps``
    times in place and writes it once; ``ctl_mxu`` and ``ctl_both`` take
    ``steps * dots`` :func:`decay_step` of ``a``."""
    if mode not in CTL_MODES:
        raise ValueError(f"mode must be one of {CTL_MODES}, got {mode!r}")
    n_blocks, n_chunks = a.shape[0], x.shape[0]
    if n_chunks < n_blocks:
        raise ValueError(f"{n_chunks} chunks for {n_blocks} blocks")
    s = torch.tensor(scale, dtype=torch.float32)
    y = y.clone()
    if mode == "ctl_mxu":
        if steps:
            idx = ctl_chunks(0, n_blocks, n_chunks).to(x.device)
            z = x[idx]
            for _ in range(steps):
                z = z * s
            y[idx] = z
    else:
        for i in range(steps):
            idx = ctl_chunks(i, n_blocks, n_chunks).to(x.device)
            y[idx] = x[idx] * s
    if mode != "ctl_dma":
        for _ in range(steps * dots):
            a = decay_step(a, w)
    return y, a.clone()


# --------------------------------------------------------------------------
# Wrappers
# --------------------------------------------------------------------------


def _route(name: str, *tensors: torch.Tensor) -> bool:
    """True for the kernel (CUDA tensors), False for the plain version
    (CPU tensors); raises on anything else."""
    dev = tensors[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda" or any(t.device.type != "cuda" for t in tensors):
        raise RuntimeError(
            f"{name} runs on CPU (plain) or CUDA (kernel) tensors, not {tensors[0].device}"
        )
    return True


def _check(t: torch.Tensor, name: str, shape, dtype) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype}, got {tuple(t.shape)} {t.dtype}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _resident_blocks(name: str, *args: int) -> int:
    """``mca_<name>_blocks``: SMs x the blocks of the kernel one SM holds."""
    fn = getattr(_build.library(name), f"mca_{name}_blocks")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    out = ctypes.c_int(0)
    _build.check(name, fn(*args, ctypes.byref(out)))
    return out.value


def counter_blocks(mode: str) -> int:
    """Blocks of K6's ``mode`` that reside on the card at once."""
    counter_shapes(mode)
    return _resident_blocks("roofline_counter", COUNTER_MODES.index(mode))


def probe_blocks() -> int:
    return _resident_blocks("probe_overlap")


def ctl_blocks() -> int:
    return _resident_blocks("probe_overlap_ctl")


def roofline_counter(mode: str, x0, aux, iters: int, eps: float):
    """K6 on CUDA tensors, its plain version on CPU ones: ``iters``
    iterations of ``mode``'s body on every block's tile of ``x0``."""
    tile, dtype, aux_shape = counter_shapes(mode)
    if not _route("roofline_counter", x0, *([aux] if aux_shape else [])):
        return counter_reference(mode, x0, aux, iters, eps)
    n = x0.shape[0]
    _check(x0, "x0", (n, *tile), dtype)
    if aux_shape:
        _check(aux, "aux", aux_shape, _BF16)
    out = torch.empty_like(x0)
    fn = _build.function(
        "roofline_counter",
        [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
        + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        COUNTER_MODES.index(mode), x0.data_ptr(),
        aux.data_ptr() if aux_shape else None, out.data_ptr(), n, iters,
        eps, _stream(x0),
    )
    _build.check("roofline_counter", err)
    launches["roofline_counter"] += 1
    return out


def probe_overlap(mode: str, a, w, b, iters: int):
    """K7 on CUDA tensors, its plain version on CPU ones; returns
    ``(a, b)`` after ``iters`` iterations."""
    if mode not in PROBE_MODES:
        raise ValueError(f"mode must be one of {PROBE_MODES}, got {mode!r}")
    if not _route("probe_overlap", a, w, b):
        return probe_reference(mode, a, w, b, iters)
    n = a.shape[0]
    _check(a, "a", (n, CHAIN_ROWS, CHAIN_W), _BF16)
    _check(w, "w", (CHAIN_W, CHAIN_W), _BF16)
    _check(b, "b", (n, *EXP_SHAPE), torch.float32)
    a_out, b_out = torch.empty_like(a), torch.empty_like(b)
    fn = _build.function(
        "probe_overlap",
        [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    )
    err = fn(
        PROBE_MODES.index(mode), a.data_ptr(), w.data_ptr(), b.data_ptr(),
        a_out.data_ptr(), b_out.data_ptr(), n, iters, _stream(a),
    )
    _build.check("probe_overlap", err)
    launches["probe_overlap"] += 1
    return a_out, b_out


def probe_overlap_ctl(mode: str, x, y, a, w, steps: int, dots: int, scale: float):
    """K8 on CUDA tensors, its plain version on CPU ones; returns ``(y,
    a)``.  The kernel writes ``y`` in place; the plain version returns a
    new one."""
    if mode not in CTL_MODES:
        raise ValueError(f"mode must be one of {CTL_MODES}, got {mode!r}")
    if not _route("probe_overlap_ctl", x, y, a, w):
        return ctl_reference(mode, x, y, a, w, steps, dots, scale)
    n_chunks, n = x.shape[0], a.shape[0]
    _check(x, "x", (n_chunks, *CHUNK_SHAPE), torch.float32)
    _check(y, "y", (n_chunks, *CHUNK_SHAPE), torch.float32)
    _check(a, "a", (n, CHAIN_ROWS, CHAIN_W), _BF16)
    _check(w, "w", (CHAIN_W, CHAIN_W), _BF16)
    a_out = torch.empty_like(a)
    fn = _build.function(
        "probe_overlap_ctl",
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        CTL_MODES.index(mode), x.data_ptr(), y.data_ptr(), n_chunks,
        a.data_ptr(), w.data_ptr(), a_out.data_ptr(), n, steps, dots,
        scale, _stream(a),
    )
    _build.check("probe_overlap_ctl", err)
    launches["probe_overlap_ctl"] += 1
    return y, a_out
