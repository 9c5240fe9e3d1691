"""Block-sparse masked flash attention, forward: Hopper kernel + plain version.

The TPU kernel this replaces is ``mca_tpu/ops/flash_attention.py::
_fwd_kernel``; the CUDA kernel is ``mca_tpu_torch/csrc/flash_fwd.cu``,
whose header says what bounds it on the card and what its design does
about that.

Semantics (shared by the kernel and :func:`flash_attention_reference`):

- ``attn_mask`` [Tq, Tk] bool, True = blocked, STATIC (numpy, shared by
  batch and heads): it becomes a CSR tile schedule at ``BLOCK`` = 64;
- ``key_padding_mask`` [B, Tk] bool, True = padded key, dynamic;
- scale folded into q in the input dtype, fp32 scores and softmax
  statistics, p rounded to the input dtype for the p.v product;
- a fully masked query row returns **zeros** and lse ``NEG_INF`` (the
  dense oracle gives a uniform average there; such rows only occur at
  padded positions, whose outputs are never consumed).

:func:`flash_attention` is the wrapper: a CPU tensor goes to the plain
version, a CUDA tensor to the kernel, anything else raises.  There is
no fallback from the kernel to the plain version.  ``launches`` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mca_tpu_torch import _build

NEG_INF = -1e30
DEAD_CLAMP = -1e29
BLOCK = 64
HEAD_DIM = 64

#: kernel launches by :func:`flash_attention` (plain-version calls excluded)
launches = 0

# (id(mask), device) -> (mask, schedule tensors on that device)
_SCHED_CACHE: Dict[Tuple[int, str], tuple] = {}


def tile_schedule(
    mask: np.ndarray, block: int = BLOCK
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR enumeration of the tiles the static mask leaves any entry of.

    Returns ``(row_ptr [nq + 1], col_idx [n_tiles], full [n_tiles])``,
    int32, q-major: q tile ``i`` visits kv tiles
    ``col_idx[row_ptr[i]:row_ptr[i + 1]]``.  ``full`` is 1 where the
    tile has no blocked entry (the kernel then skips the mask read).
    The region past the mask's edge counts as blocked.  The q-major half
    of ``mca_tpu.ops.flash_attention._tile_schedule`` at the GPU tile
    size; a q tile with no active tile simply has an empty row (its
    rows are dead and come out as zeros).
    """
    t, s = mask.shape
    nq, nk = -(-t // block), -(-s // block)
    padded = np.ones((nq * block, nk * block), dtype=bool)
    padded[:t, :s] = mask
    tiles = padded.reshape(nq, block, nk, block)
    active = ~tiles.all(axis=(1, 3))  # [nq, nk]
    full = ~tiles.any(axis=(1, 3))
    qs, ks = np.nonzero(active)  # row-major == q-major
    row_ptr = np.zeros(nq + 1, np.int32)
    np.cumsum(active.sum(axis=1), out=row_ptr[1:])
    return row_ptr, ks.astype(np.int32), full[qs, ks].astype(np.int32)


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_mask: Optional[np.ndarray],
    key_padding_mask: Optional[torch.Tensor],
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: ``[B, H, Tq, D]`` q and
    ``[B, H, Tk, D]`` k, v -> ``(out [B, H, Tq, D], lse [B, H, Tq])``.

    Walks the same CSR schedule as the kernel, one q tile at a time:
    the keys of the tile's visited kv tiles are gathered and softmaxed
    at once (the online softmax of the kernel computes the same value).
    """
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if attn_mask is None:
        attn_mask = np.zeros((tq, tk), bool)
    attn_mask = np.asarray(attn_mask, bool)
    row_ptr, col_idx, _ = tile_schedule(attn_mask)
    dev = q.device
    mask_t = torch.from_numpy(attn_mask).to(dev)
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    out = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    lse = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=dev)
    for i in range(len(row_ptr) - 1):
        q0, q1 = i * BLOCK, min((i + 1) * BLOCK, tq)
        tiles = col_idx[row_ptr[i] : row_ptr[i + 1]]
        if len(tiles) == 0:
            continue
        keys = np.concatenate(
            [np.arange(j * BLOCK, min((j + 1) * BLOCK, tk)) for j in tiles]
        )
        keys_t = torch.from_numpy(keys).to(dev)
        s = torch.einsum(
            "bhqd,bhkd->bhqk", qs[:, :, q0:q1], k[:, :, keys_t].float()
        )
        blocked = mask_t[q0:q1][:, keys_t][None, None]
        if key_padding_mask is not None:
            blocked = blocked | key_padding_mask[:, keys_t].bool()[
                :, None, None, :
            ]
        s = s.masked_fill(blocked, NEG_INF)
        m = s.amax(dim=-1, keepdim=True).clamp(min=DEAD_CLAMP)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum(
            "bhqk,bhkd->bhqd",
            p.to(v.dtype).float(),
            v[:, :, keys_t].float(),
        )
        live = l > 0
        out[:, :, q0:q1] = torch.where(
            live, acc / torch.where(live, l, torch.ones_like(l)), 0.0
        )
        lse[:, :, q0:q1] = torch.where(
            live,
            m + torch.log(torch.where(live, l, torch.ones_like(l))),
            NEG_INF,
        )[..., 0]
    return out.to(q.dtype), lse


def _schedule_on(mask: np.ndarray, device: torch.device):
    """The mask's schedule and its uint8 copy on ``device``, built and
    uploaded once per static mask (kept alive with the entry, so its id
    cannot be reused while cached)."""
    key = (id(mask), str(device))
    hit = _SCHED_CACHE.get(key)
    if hit is None or hit[0] is not mask:
        row_ptr, col_idx, full = tile_schedule(mask)
        tensors = tuple(
            torch.from_numpy(a).to(device)
            for a in (
                row_ptr,
                col_idx,
                full,
                np.ascontiguousarray(mask, dtype=np.uint8),
            )
        )
        hit = (mask, tensors)
        _SCHED_CACHE[key] = hit
    return hit[1]


def _check_cuda(t: torch.Tensor, name: str, shape, dtype) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name} must be a CUDA tensor, got {t.device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError(
            f"{name}: expected {tuple(shape)} {dtype}, got "
            f"{tuple(t.shape)} {t.dtype}"
        )
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_mask: Optional[np.ndarray],
    key_padding_mask: Optional[torch.Tensor],
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked attention ``(out, lse)`` through the Hopper kernel for
    CUDA tensors (bf16, head dim 64, contiguous ``[B, H, T, 64]``
    self-attention), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, attn_mask, key_padding_mask, scale
        )
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_attention runs on CPU (plain) or CUDA (kernel) "
            f"tensors, not {q.device}"
        )
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "the flash attention kernel is forward-only: its backward "
            "comes with the training slice"
        )
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_cuda(x, name, (b, h, t, d), torch.bfloat16)
    if attn_mask is None:
        attn_mask = np.zeros((t, t), bool)
    if not isinstance(attn_mask, np.ndarray) or attn_mask.shape != (t, t):
        raise ValueError(
            "attn_mask must be a static numpy [T, T] array (it becomes "
            "the kernel's tile schedule)"
        )
    row_ptr, col_idx, full, mask_u8 = _schedule_on(attn_mask, q.device)
    pad = None
    if key_padding_mask is not None:
        pad = key_padding_mask
        if pad.dtype != torch.bool:
            pad = pad.bool()
        pad = pad.contiguous()
        _check_cuda(pad, "key_padding_mask", (b, t), torch.bool)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.function(
        "flash_fwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
    )
    # the scale as the kernel applies it: rounded to q's dtype first,
    # like the TPU kernel's jnp.asarray(scale, q.dtype)
    scale_q = float(torch.tensor(scale, dtype=q.dtype))
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
        pad.data_ptr() if pad is not None else None,
        row_ptr.data_ptr(), col_idx.data_ptr(), full.data_ptr(),
        out.data_ptr(), lse.data_ptr(),
        b * h, h, t, len(row_ptr) - 1, scale_q,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_fwd", err)
    global launches
    launches += 1
    return out, lse
