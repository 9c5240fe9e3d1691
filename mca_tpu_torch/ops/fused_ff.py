"""Fused GEGLU feed-forward, forward: Hopper kernel + plain version.

The TPU kernel this replaces is ``mca_tpu/ops/fused_ff.py::_ff_kernel``;
the CUDA kernel is ``mca_tpu_torch/csrc/geglu_ff.cu``, whose header says
what bounds it on the card and what its design does about that.

``out = (gelu_erf(g) * u) @ W2`` with ``[u | g] = x @ W1`` (u the first
half); u and g accumulate in fp32 and are not rounded, the gated
product is rounded to the input dtype before ``@ W2``, and the output
is in the input dtype.  Weights are in ``[in, out]`` layout, as in the
JAX package.

The kernel takes W1's halves and W2 zero-padded to a multiple of 64
inner columns; :func:`prepare_geglu_weights` does that once, when the
weights are loaded.  :func:`geglu_ff` is the wrapper: CPU tensors go to
the plain version, CUDA tensors to the kernel, anything else raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from mca_tpu_torch import _build

INNER_MULTIPLE = 64
MODEL_DIM = 512

#: kernel launches by :func:`geglu_ff` (plain-version calls excluded)
launches = 0


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def prepare_geglu_weights(
    w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``w1`` [D, 2*inner], ``w2`` [inner, D_out] -> ``(w1u, w1g, w2p)``
    in ``dtype``: the u and gate halves of W1 as [D, inner_p] and W2 as
    [inner_p, D_out], zero-padded to ``inner_p``, a multiple of 64."""
    d, two_inner = w1.shape
    inner = two_inner // 2
    assert w2.shape[0] == inner, (w1.shape, w2.shape)
    ip = _pad_to(inner, INNER_MULTIPLE)
    w1u = w1.new_zeros((d, ip), dtype=dtype)
    w1g = w1.new_zeros((d, ip), dtype=dtype)
    w2p = w2.new_zeros((ip, w2.shape[1]), dtype=dtype)
    w1u[:, :inner] = w1[:, :inner]
    w1g[:, :inner] = w1[:, inner:]
    w2p[:inner] = w2
    return w1u.contiguous(), w1g.contiguous(), w2p.contiguous()


def geglu_ff_plain(
    x: torch.Tensor,
    w1u: torch.Tensor,
    w1g: torch.Tensor,
    w2: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel on split weights (padded or
    not): fp32 u and g, fp32 exact-erf gate, gated product rounded to
    ``x.dtype``, fp32 accumulation of ``@ w2``, output in ``x.dtype``."""
    x32 = x.float()
    u = x32 @ w1u.float()
    g = x32 @ w1g.float()
    a = 0.5 * g * (1.0 + torch.erf(g * (1.0 / math.sqrt(2.0)))) * u
    return (a.to(x.dtype).float() @ w2.float()).to(x.dtype)


def geglu_ff_reference(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """The unfused semantics on the unsplit weights, ``[u | g] = x @ w1;
    out = (gelu_erf(g) * u) @ w2`` (``mca_tpu.ops.fused_ff.
    geglu_ff_reference``), with the kernel's dtype chain."""
    inner = w2.shape[0]
    return geglu_ff_plain(x, w1[:, :inner], w1[:, inner:], w2)


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


def geglu_ff(
    x: torch.Tensor,
    w1u: torch.Tensor,
    w1g: torch.Tensor,
    w2p: torch.Tensor,
) -> torch.Tensor:
    """GEGLU FF on weights from :func:`prepare_geglu_weights`; ``x`` is
    ``[..., D]``.  CUDA: the fused kernel (bf16, D = D_out = 512,
    forward only).  CPU: the plain version."""
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w1u, w1g, w2p)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"geglu_ff runs on CPU (plain) or CUDA (kernel) tensors, "
            f"not {x.device}"
        )
    if any(t.requires_grad for t in (x, w1u, w1g, w2p)):
        raise RuntimeError(
            "the fused GEGLU kernel is forward-only: its backward comes "
            "with the training slice"
        )
    d, ip = w1u.shape
    if d != MODEL_DIM or w2p.shape[1] != MODEL_DIM or ip % INNER_MULTIPLE:
        raise ValueError(
            f"the kernel takes D = D_out = {MODEL_DIM} and inner padded "
            f"to a multiple of {INNER_MULTIPLE}; got w1u {tuple(w1u.shape)}"
            f", w2 {tuple(w2p.shape)}"
        )
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d)
    n = x2.shape[0]
    _check_cuda(x2, "x", (n, d))
    _check_cuda(w1u, "w1u", (d, ip))
    _check_cuda(w1g, "w1g", (d, ip))
    _check_cuda(w2p, "w2", (ip, d))
    out = torch.empty((n, d), dtype=x.dtype, device=x.device)
    fn = _build.function(
        "geglu_ff", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    )
    err = fn(
        x2.data_ptr(), w1u.data_ptr(), w1g.data_ptr(), w2p.data_ptr(),
        out.data_ptr(), n, ip,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check("geglu_ff", err)
    global launches
    launches += 1
    return out.reshape(*lead, d)
