"""Block-sparse masked flash attention: Hopper kernels + plain versions.

The TPU kernels this replaces are ``mca_tpu/ops/flash_attention.py``'s
``_fwd_kernel`` (forward), ``_fused_bwd_kernel`` (the default backward)
and the split pair ``_dq_kernel`` + ``_dkv_kernel``; the CUDA kernels
are ``mca_tpu_torch/csrc/flash_fwd.cu`` (K1), ``flash_bwd.cu`` (K2),
``flash_bwd_dq.cu`` (K3a) and ``flash_bwd_dkv.cu`` (K3b), whose headers
say what bounds them on the card and what their design does about it.

Semantics (shared by the kernels and the plain versions
:func:`flash_attention_reference` / :func:`flash_attention_bwd_reference`):

- ``attn_mask`` [Tq, Tk] bool, True = blocked, STATIC (numpy, shared by
  batch and heads): it becomes a CSR tile schedule at ``BLOCK`` = 64,
  q-major for dq, over pairs of q tiles for the forward
  (:func:`pair_schedule`), over pairs of kv tiles for dk and dv
  (:func:`kv_pair_schedule`);
- ``key_padding_mask`` [B, Tk] bool, True = padded key, dynamic;
- scale folded into q in the input dtype, fp32 scores and softmax
  statistics, p (and in the backward ds) rounded to the input dtype for
  the products that take them, fp32 accumulation;
- a fully masked query row returns **zeros** and lse ``NEG_INF`` (the
  dense oracle gives a uniform average there; such rows only occur at
  padded positions, whose outputs are never consumed); its dq is 0, and
  a padded key's dk and dv are 0.

:func:`flash_attention` is the differentiable wrapper: a CPU tensor goes
to the plain versions, a CUDA tensor to the kernels (the backward to K2
with ``bwd_impl="fused"``, the default as in the JAX package, or to
K3a + K3b with ``"split"``; a call that names none takes
``default_bwd_impl``), anything else raises.  There is no fallback
from a kernel to a plain version.  ``launches`` counts forward kernel
launches, ``bwd_launches`` backward ones per kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mca_tpu_torch import _build

NEG_INF = -1e30
DEAD_CLAMP = -1e29
BLOCK = 64
HEAD_DIM = 64
BWD_IMPLS = ("fused", "split")

#: the backward of a :func:`flash_attention` call that names none:
#: ``fused`` (K2), or ``split`` (K3a + K3b, whose dq is deterministic);
#: set it to drive a whole model through the other route
default_bwd_impl = "fused"

#: kernel launches by :func:`flash_attention`'s forward (plain-version
#: calls excluded)
launches = 0
#: backward kernel launches, per kernel (plain-version calls excluded)
bwd_launches = {"flash_bwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}

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


def kv_tile_schedule(
    mask: np.ndarray, block: int = BLOCK
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The same tiles kv-major: ``(col_ptr [nk + 1], row_idx [n_tiles],
    full [n_tiles])``; kv tile ``j`` visits q tiles
    ``row_idx[col_ptr[j]:col_ptr[j + 1]]`` in increasing order.  The
    kv-major half of ``_tile_schedule``; a kv tile with no active tile
    has an empty column (its keys get dk = dv = 0)."""
    row_ptr, col_idx, full = tile_schedule(mask, block)
    nk = -(-mask.shape[1] // block)
    rows = np.repeat(np.arange(len(row_ptr) - 1, dtype=np.int32), np.diff(row_ptr))
    order = np.lexsort((rows, col_idx))  # by kv tile, then q tile
    col_ptr = np.zeros(nk + 1, np.int32)
    np.cumsum(np.bincount(col_idx, minlength=nk), out=col_ptr[1:])
    return col_ptr, rows[order], full[order]


def pair_schedule(
    mask: np.ndarray, block: int = BLOCK
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The forward kernel's walk: q tiles in pairs ``(2i, 2i + 1)``.

    Returns ``(pair_ptr [n_pairs + 1], pair_kv [n], pair_flags [n],
    pair_bits [n, 2, 64])``: pair ``i`` visits kv tiles
    ``pair_kv[pair_ptr[i]:pair_ptr[i + 1]]``, in increasing order, the
    union of the two q tiles' rows of :func:`tile_schedule` (a q tile
    past the last one has an empty row).  ``pair_flags`` has bit ``h``
    set where q tile ``2i + h`` visits the tile and bit ``2 + h`` where
    that tile is also ``full``.  ``pair_bits[n, h, r]`` holds row ``r`` of
    that 64 x 64 tile of the mask as bits (bit ``c``: key ``c`` blocked,
    the region past the mask's edge blocked), as int64.  The 64 x 64
    tile stays the unit of skipping, as in the backward's schedules.
    """
    assert block == 64, "the mask bits of a tile row fill one 64-bit word"
    row_ptr, col_idx, full = tile_schedule(mask, block)
    t, s = mask.shape
    nq, nk = len(row_ptr) - 1, -(-s // block)
    n_pairs = -(-nq // 2)
    rows = np.repeat(np.arange(nq, dtype=np.int64), np.diff(row_ptr))
    items, inv = np.unique((rows // 2) * nk + col_idx, return_inverse=True)
    flags = np.zeros(len(items), np.int64)
    half = rows % 2
    np.bitwise_or.at(flags, inv.reshape(-1), (1 << half) | (full.astype(np.int64) << (2 + half)))
    pair_of, pair_kv = items // nk, items % nk
    pair_ptr = np.zeros(n_pairs + 1, np.int32)
    np.cumsum(np.bincount(pair_of, minlength=n_pairs), out=pair_ptr[1:])
    padded = np.ones((2 * n_pairs * block, nk * block), dtype=bool)
    padded[:t, :s] = mask
    tiles = padded.reshape(n_pairs, 2, block, nk, block)[pair_of, :, :, pair_kv, :]
    weights = np.left_shift(np.uint64(1), np.arange(block, dtype=np.uint64))
    bits = (tiles.astype(np.uint64) * weights).sum(axis=-1, dtype=np.uint64)
    return (
        pair_ptr, pair_kv.astype(np.int32), flags.astype(np.int32),
        np.ascontiguousarray(bits).view(np.int64),
    )


def kv_pair_schedule(
    mask: np.ndarray, block: int = BLOCK
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The kv-major backward kernels' walk: kv tiles in pairs ``(2j, 2j + 1)``.

    :func:`pair_schedule` of the transposed mask: ``(pair_ptr [n_pairs +
    1], pair_q [n], pair_flags [n], pair_bits [n, 2, 64])``; pair ``j``
    visits q tiles ``pair_q[pair_ptr[j]:pair_ptr[j + 1]]``, in increasing
    order, the union of kv tiles ``2j`` and ``2j + 1``'s columns of
    :func:`kv_tile_schedule`.  ``pair_flags`` bit ``h``: kv tile ``2j + h``
    visits the q tile, bit ``2 + h``: that tile is also ``full``.
    ``pair_bits[n, h, r]`` holds row ``r`` of the TRANSPOSED 64 x 64 tile
    (rows = keys, bit ``c``: query ``c`` blocked), the region past the
    mask's edge blocked, as int64.
    """
    return pair_schedule(np.ascontiguousarray(np.asarray(mask, bool).T), block)


def kv_pair_order(pair_ptr: np.ndarray) -> np.ndarray:
    """The order in which K2 / K3b start their pairs of kv tiles: longest
    walk first (ties in pair order), int32; from
    :func:`kv_pair_schedule`'s ``pair_ptr``."""
    return np.argsort(-np.diff(pair_ptr), kind="stable").astype(np.int32)


def _tile_keys(tiles: np.ndarray, tk: int) -> np.ndarray:
    return np.concatenate(
        [np.arange(j * BLOCK, min((j + 1) * BLOCK, tk)) for j in tiles]
    )


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
        keys_t = torch.from_numpy(_tile_keys(tiles, tk)).to(dev)
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


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(do * out)`` in fp32, ``[B, H, T]``: the JAX
    package computes it outside its kernels too."""
    return (do.float() * out.float()).sum(dim=-1)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_mask: Optional[np.ndarray],
    key_padding_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels: ``(dq, dk, dv)``
    in the inputs' dtype.

    As ``_dq_kernel`` / ``_dkv_kernel`` (and the fused kernel) compute
    it: p recomputed from ``lse`` floored at ``DEAD_CLAMP`` (dead rows
    give p = 0), ``delta = rowsum(do * out)`` in fp32,
    ``dv = bf16(p)^T do``, ``dp = do v^T``, ``ds = p (dp - delta)``,
    ``dk = bf16(ds)^T q_s`` and ``dq = scale * bf16(ds) k`` (bf16 standing
    for the input dtype), with the scale folded into ``q_s`` in the
    input dtype.  Walks the q-major schedule one q tile at a time;
    dk and dv contributions are added to the tile's gathered keys.
    """
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if attn_mask is None:
        attn_mask = np.zeros((tq, tk), bool)
    attn_mask = np.asarray(attn_mask, bool)
    row_ptr, col_idx, _ = tile_schedule(attn_mask)
    dev = q.device
    mask_t = torch.from_numpy(attn_mask).to(dev)
    qs = q * torch.tensor(scale, dtype=q.dtype)
    delta = attention_delta(out, do)
    lse_c = lse.clamp(min=DEAD_CLAMP)
    dq = torch.zeros((b, h, tq, d), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, h, tk, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, h, tk, d), dtype=torch.float32, device=dev)
    for i in range(len(row_ptr) - 1):
        q0, q1 = i * BLOCK, min((i + 1) * BLOCK, tq)
        tiles = col_idx[row_ptr[i] : row_ptr[i + 1]]
        if len(tiles) == 0:
            continue
        keys_t = torch.from_numpy(_tile_keys(tiles, tk)).to(dev)
        kk, vk = k[:, :, keys_t].float(), v[:, :, keys_t].float()
        qi, doi = qs[:, :, q0:q1].float(), do[:, :, q0:q1].float()
        s = torch.einsum("bhqd,bhkd->bhqk", qi, kk)
        blocked = mask_t[q0:q1][:, keys_t][None, None]
        if key_padding_mask is not None:
            blocked = blocked | key_padding_mask[:, keys_t].bool()[
                :, None, None, :
            ]
        s = s.masked_fill(blocked, NEG_INF)
        p = torch.exp(s - lse_c[:, :, q0:q1, None])
        dp = torch.einsum("bhqd,bhkd->bhqk", doi, vk)
        ds = p * (dp - delta[:, :, q0:q1, None])
        p_in = p.to(v.dtype).float()
        ds_in = ds.to(q.dtype).float()
        dv.index_add_(2, keys_t, torch.einsum("bhqk,bhqd->bhkd", p_in, doi))
        dk.index_add_(2, keys_t, torch.einsum("bhqk,bhqd->bhkd", ds_in, qi))
        dq[:, :, q0:q1] = scale * torch.einsum("bhqk,bhkd->bhqd", ds_in, kk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _schedule_on(mask: np.ndarray, device: torch.device) -> dict:
    """The mask's schedules and its uint8 copy on ``device``, built and
    uploaded once per static mask (kept alive with the entry, so its id
    cannot be reused while cached): ``{"tile": tile_schedule (K3a),
    "mask": the mask as uint8 (K3a), "pair": pair_schedule (K1),
    "kv_pair": kv_pair_schedule and kv_pair_order (K2, K3b)}``, each
    schedule a tuple of tensors."""
    key = (id(mask), str(device))
    hit = _SCHED_CACHE.get(key)
    if hit is None or hit[0] is not mask:
        def up(arrays):
            return tuple(torch.from_numpy(a).to(device) for a in arrays)

        kv_pair = kv_pair_schedule(mask)
        hit = (mask, {
            "tile": up(tile_schedule(mask)),
            "mask": up([np.ascontiguousarray(mask, dtype=np.uint8)])[0],
            "pair": up(pair_schedule(mask)),
            "kv_pair": up((*kv_pair, kv_pair_order(kv_pair[0]))),
        })
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


def _kernel_args(q, k, v, attn_mask, key_padding_mask):
    """Check the kernels' inputs; returns ``(mask, pad)`` with the mask
    as a static numpy array and the padding as contiguous bool or None."""
    b, h, t, d = q.shape
    if d != HEAD_DIM:
        raise ValueError(f"the kernels take head dim {HEAD_DIM}, got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_cuda(x, name, (b, h, t, d), torch.bfloat16)
    if attn_mask is None:
        attn_mask = np.zeros((t, t), bool)
    if not isinstance(attn_mask, np.ndarray) or attn_mask.shape != (t, t):
        raise ValueError(
            "attn_mask must be a static numpy [T, T] array (it becomes "
            "the kernels' tile schedule)"
        )
    pad = None
    if key_padding_mask is not None:
        pad = key_padding_mask
        if pad.dtype != torch.bool:
            pad = pad.bool()
        pad = pad.contiguous()
        _check_cuda(pad, "key_padding_mask", (b, t), torch.bool)
    return attn_mask, pad


def _scale_q(scale: float, dtype: torch.dtype) -> float:
    """The scale as the kernels apply it to q: rounded to q's dtype
    first, like the TPU kernels' ``jnp.asarray(scale, q.dtype)``."""
    return float(torch.tensor(scale, dtype=dtype))


def _q_operand(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """``(q as the kv-major backward kernels read it, scale_s)``: they
    multiply s = q k^T and dk by ``scale_s`` in fp32, where the TPU
    kernels fold ``bf16(scale)`` into q in bf16.  Where that scale is a
    power of two (the model's 64^-0.5 = 2^-3) both give the same s and dk
    bit for bit (barring subnormal products), and q goes in as it is with ``scale_s`` = the scale;
    otherwise q goes in as ``q_s = q * bf16(scale)`` (one bf16 pass) with
    ``scale_s`` = 1."""
    sq = _scale_q(scale, q.dtype)
    if math.frexp(sq)[0] == 0.5:
        return q, sq
    return q * torch.tensor(sq, dtype=q.dtype, device=q.device), 1.0


def _flash_fwd_kernel(q, k, v, attn_mask, key_padding_mask, scale):
    attn_mask, pad = _kernel_args(q, k, v, attn_mask, key_padding_mask)
    b, h, t, _ = q.shape
    pair_ptr, pair_kv, pair_flags, pair_bits = _schedule_on(attn_mask, q.device)["pair"]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.function(
        "flash_fwd",
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        pad.data_ptr() if pad is not None else None,
        pair_ptr.data_ptr(), pair_kv.data_ptr(), pair_flags.data_ptr(),
        pair_bits.data_ptr(), out.data_ptr(), lse.data_ptr(),
        b * h, h, t, len(pair_ptr) - 1, _scale_q(scale, q.dtype),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check("flash_fwd", err)
    global launches
    launches += 1
    return out, lse


def _bwd_common(q, k, v, do, lse, delta, attn_mask, key_padding_mask):
    """Checks shared by the three backward entry points; returns the
    mask's schedules on the device and the key padding (or None)."""
    attn_mask, pad = _kernel_args(q, k, v, attn_mask, key_padding_mask)
    b, h, t, d = q.shape
    _check_cuda(do, "do", (b, h, t, d), torch.bfloat16)
    _check_cuda(lse, "lse", (b, h, t), torch.float32)
    _check_cuda(delta, "delta", (b, h, t), torch.float32)
    return _schedule_on(attn_mask, q.device), pad


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _ptr(x: Optional[torch.Tensor]):
    return x.data_ptr() if x is not None else None


def flash_bwd(q, k, v, do, lse, delta, attn_mask, key_padding_mask, scale,
              dq_acc, dk, dv) -> None:
    """Launch K2: dk, dv written, dq added into the fp32 ``dq_acc``
    (zeroed by the caller).  CUDA tensors only."""
    sched, pad = _bwd_common(
        q, k, v, do, lse, delta, attn_mask, key_padding_mask
    )
    b, h, t, d = q.shape
    _check_cuda(dq_acc, "dq_acc", (b, h, t, d), torch.float32)
    _check_cuda(dk, "dk", (b, h, t, d), torch.bfloat16)
    _check_cuda(dv, "dv", (b, h, t, d), torch.bfloat16)
    q_in, scale_s = _q_operand(q, scale)
    fn = _build.function(
        "flash_bwd",
        [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    )
    err = fn(
        q_in.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(pad),
        *(x.data_ptr() for x in sched["kv_pair"]),
        dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, h, t,
        len(sched["kv_pair"][0]) - 1, scale_s, float(scale), _stream(q),
    )
    _build.check("flash_bwd", err)
    bwd_launches["flash_bwd"] += 1


def flash_bwd_dq(q, k, v, do, lse, delta, attn_mask, key_padding_mask,
                 scale, dq) -> None:
    """Launch K3a: dq (bf16) written.  CUDA tensors only."""
    sched, pad = _bwd_common(
        q, k, v, do, lse, delta, attn_mask, key_padding_mask
    )
    b, h, t, d = q.shape
    _check_cuda(dq, "dq", (b, h, t, d), torch.bfloat16)
    row_ptr, col_idx, full = sched["tile"]
    fn = _build.function(
        "flash_bwd_dq",
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
        + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    )
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), sched["mask"].data_ptr(), _ptr(pad),
        row_ptr.data_ptr(), col_idx.data_ptr(), full.data_ptr(),
        dq.data_ptr(), b * h, h, t, len(row_ptr) - 1,
        _scale_q(scale, q.dtype), float(scale), _stream(q),
    )
    _build.check("flash_bwd_dq", err)
    bwd_launches["flash_bwd_dq"] += 1


def flash_bwd_dkv(q, k, v, do, lse, delta, attn_mask, key_padding_mask,
                  scale, dk, dv) -> None:
    """Launch K3b: dk and dv (bf16) written.  CUDA tensors only."""
    sched, pad = _bwd_common(
        q, k, v, do, lse, delta, attn_mask, key_padding_mask
    )
    b, h, t, d = q.shape
    _check_cuda(dk, "dk", (b, h, t, d), torch.bfloat16)
    _check_cuda(dv, "dv", (b, h, t, d), torch.bfloat16)
    q_in, scale_s = _q_operand(q, scale)
    fn = _build.function(
        "flash_bwd_dkv",
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
    )
    err = fn(
        q_in.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(pad),
        *(x.data_ptr() for x in sched["kv_pair"]),
        dk.data_ptr(), dv.data_ptr(), b * h, h, t, len(sched["kv_pair"][0]) - 1,
        scale_s, _stream(q),
    )
    _build.check("flash_bwd_dkv", err)
    bwd_launches["flash_bwd_dkv"] += 1


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_mask: Optional[np.ndarray],
    key_padding_mask: Optional[torch.Tensor],
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float,
    bwd_impl: str = "fused",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` through the backward kernels for CUDA tensors
    (K2 for ``bwd_impl="fused"``, K3a + K3b for ``"split"``), the plain
    version for CPU tensors (both impls compute the same function)."""
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
    if q.device.type == "cpu":
        return flash_attention_bwd_reference(
            q, k, v, attn_mask, key_padding_mask, out, lse, do, scale
        )
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_attention runs on CPU (plain) or CUDA (kernel) "
            f"tensors, not {q.device}"
        )
    do = do.contiguous()
    delta = attention_delta(out, do)
    args = (q, k, v, do, lse, delta, attn_mask, key_padding_mask, scale)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if bwd_impl == "fused":
        dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        flash_bwd(*args, dq_acc, dk, dv)
        return dq_acc.to(q.dtype), dk, dv
    dq = torch.empty_like(q)
    flash_bwd_dq(*args, dq)
    flash_bwd_dkv(*args, dk, dv)
    return dq, dk, dv


def _forward(q, k, v, attn_mask, key_padding_mask, scale):
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, attn_mask, key_padding_mask, scale
        )
    if q.device.type != "cuda":
        raise RuntimeError(
            f"flash_attention runs on CPU (plain) or CUDA (kernel) "
            f"tensors, not {q.device}"
        )
    return _flash_fwd_kernel(q, k, v, attn_mask, key_padding_mask, scale)


class _FlashAttention(torch.autograd.Function):
    """Forward through K1 (or its plain version), backward through K2 or
    K3a + K3b (or the plain backward); the gradient of ``lse`` is not
    defined (the JAX package's custom_vjp returns only ``out``)."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, key_padding_mask, scale, bwd_impl):
        out, lse = _forward(q, k, v, attn_mask, key_padding_mask, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attn_mask = attn_mask
        ctx.key_padding_mask = key_padding_mask
        ctx.scale = scale
        ctx.bwd_impl = bwd_impl
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, ctx.attn_mask, ctx.key_padding_mask, out, lse,
            dout, ctx.scale, ctx.bwd_impl,
        )
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    attn_mask: Optional[np.ndarray],
    key_padding_mask: Optional[torch.Tensor],
    scale: float,
    bwd_impl: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked attention ``(out, lse)`` through the Hopper kernels for
    CUDA tensors (bf16, head dim 64, contiguous ``[B, H, T, 64]``
    self-attention), the plain versions for CPU tensors; differentiable
    in q, k and v, with the backward chosen by ``bwd_impl`` (``None``:
    ``default_bwd_impl``)."""
    if bwd_impl is None:
        bwd_impl = default_bwd_impl
    if bwd_impl not in BWD_IMPLS:
        raise ValueError(f"bwd_impl must be one of {BWD_IMPLS}, got {bwd_impl!r}")
    if torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v)
    ):
        return _FlashAttention.apply(
            q, k, v, attn_mask, key_padding_mask, scale, bwd_impl
        )
    return _forward(q, k, v, attn_mask, key_padding_mask, scale)
