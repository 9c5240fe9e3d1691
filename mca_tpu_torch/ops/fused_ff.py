"""Fused GEGLU feed-forward, forward: Hopper kernel + plain version.

The TPU kernel this replaces is ``mca_tpu/ops/fused_ff.py::_ff_kernel``;
the CUDA kernel is ``mca_tpu_torch/csrc/geglu_ff.cu``, whose header says
what bounds it on the card and what its design does about that.

``out = (gelu_erf(g) * u) @ W2`` with ``[u | g] = x @ W1`` (u the first
half); u and g accumulate in fp32 and are not rounded, the gated
product is rounded to the input dtype before ``@ W2``, and the output
is in the input dtype.  Weights are in ``[in, out]`` layout, as in the
JAX package.

The kernel takes the weights in the layout :func:`prepare_geglu_weights`
makes once, when they are loaded: both transposed to ``[out, in]``
(each row one output column, its ``in`` values contiguous, the
"K-major" operand that TMA and wgmma take), the inner width zero-padded
to a multiple of 64, and W1's rows interleaved so that every 64-wide
inner chunk is ``[u 32 | g 32 | u 32 | g 32]``: a 64-row slice then gives
one warpgroup the u and the gate of the same 32 inner columns.
:func:`split_geglu_weights` undoes it.  :func:`geglu_ff` is the
wrapper: CPU tensors go to the plain version, CUDA tensors to the
kernel, anything else raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from mca_tpu_torch import _build

INNER_MULTIPLE = 64
HALF_CHUNK = INNER_MULTIPLE // 2  # inner columns of one u or gate run
MODEL_DIM = 512

#: kernel launches by :func:`geglu_ff` (plain-version calls excluded)
launches = 0


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prepare_geglu_weights(
    w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``w1`` [D, 2*inner], ``w2`` [inner, D_out] -> ``(w1t, w2t)`` in
    ``dtype``: ``w1t`` [2*inner_p, D], W1's u and gate columns as rows,
    interleaved in runs of 32 (``u[0:32], g[0:32], u[32:64], g[32:64],
    ...``), and ``w2t`` [D_out, inner_p], W2 transposed; ``inner_p`` is
    inner rounded up to a multiple of 64, the extra rows and columns
    zero."""
    d, two_inner = w1.shape
    inner = two_inner // 2
    assert w2.shape[0] == inner, (w1.shape, w2.shape)
    ip = _pad_to(inner, INNER_MULTIPLE)
    halves = w1.new_zeros((2, ip, d), dtype=dtype)
    halves[0, :inner] = w1[:, :inner].t()
    halves[1, :inner] = w1[:, inner:].t()
    w1t = halves.reshape(2, ip // HALF_CHUNK, HALF_CHUNK, d).transpose(0, 1)
    w2t = w2.new_zeros((w2.shape[1], ip), dtype=dtype)
    w2t[:, :inner] = w2.t()
    return w1t.reshape(2 * ip, d).contiguous(), w2t.contiguous()


def split_geglu_weights(
    w1t: torch.Tensor, w2t: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The prepared layout back to ``(w1u, w1g, w2p)``: W1's u and gate
    halves as [D, inner_p] and W2 as [inner_p, D_out] (still padded)."""
    two_ip, d = w1t.shape
    runs = w1t.reshape(two_ip // (2 * HALF_CHUNK), 2, HALF_CHUNK, d)
    w1u = runs[:, 0].reshape(-1, d).t()
    w1g = runs[:, 1].reshape(-1, d).t()
    return w1u, w1g, w2t.t()


def _gate(u: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """fp32 exact-erf GELU of the gate times u."""
    return 0.5 * g * (1.0 + torch.erf(g * (1.0 / math.sqrt(2.0)))) * u


def geglu_ff_plain(
    x: torch.Tensor, w1t: torch.Tensor, w2t: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on the prepared weights: fp32
    u and g, fp32 exact-erf gate, gated product rounded to ``x.dtype``,
    fp32 accumulation of ``@ W2``, output in ``x.dtype``."""
    h = x.float() @ w1t.float().t()  # [..., 2 * inner_p], interleaved
    runs = h.reshape(*h.shape[:-1], -1, 2, HALF_CHUNK)
    u = runs[..., 0, :].flatten(-2)
    g = runs[..., 1, :].flatten(-2)
    a = _gate(u, g)
    return (a.to(x.dtype).float() @ w2t.float().t()).to(x.dtype)


def geglu_ff_reference(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """The unfused semantics on the unsplit weights, ``[u | g] = x @ w1;
    out = (gelu_erf(g) * u) @ w2`` (``mca_tpu.ops.fused_ff.
    geglu_ff_reference``), with the kernel's dtype chain."""
    u, g = (x.float() @ w1.float()).chunk(2, dim=-1)
    return (_gate(u, g).to(x.dtype).float() @ w2.float()).to(x.dtype)


def _check_cuda(t: torch.Tensor, name: str, shape) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != torch.bfloat16:
        raise ValueError(
            f"{name}: expected {tuple(shape)} bf16, got "
            f"{tuple(t.shape)} {t.dtype}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def geglu_ff(x: torch.Tensor, w1t: torch.Tensor, w2t: torch.Tensor) -> torch.Tensor:
    """GEGLU FF on weights from :func:`prepare_geglu_weights`; ``x`` is
    ``[..., D]``.  CUDA: the fused kernel (bf16, D = D_out = 512,
    forward only).  CPU: the plain version."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w1t, w2t)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"geglu_ff runs on CPU (plain) or CUDA (kernel) tensors, "
            f"not {x.device}"
        )
    if any(t.requires_grad for t in (x, w1t, w2t)):
        raise RuntimeError(
            "the fused GEGLU kernel is forward-only: training runs the "
            "unfused chain"
        )
    two_ip, d = w1t.shape
    ip = two_ip // 2
    if d != MODEL_DIM or w2t.shape[0] != MODEL_DIM or ip % INNER_MULTIPLE:
        raise ValueError(
            f"the kernel takes D = D_out = {MODEL_DIM} and inner padded "
            f"to a multiple of {INNER_MULTIPLE}; got w1t {tuple(w1t.shape)}"
            f", w2t {tuple(w2t.shape)}"
        )
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d)
    n = x2.shape[0]
    _check_cuda(x2, "x", (n, d))
    _check_cuda(w1t, "w1t", (two_ip, d))
    _check_cuda(w2t, "w2t", (d, ip))
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    fn = _build.function(
        "geglu_ff", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    err = fn(
        x2.data_ptr(), w1t.data_ptr(), w2t.data_ptr(), out.data_ptr(), n, ip,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("geglu_ff", err)
    global launches
    launches += 1
    return out.reshape(*lead, d)
