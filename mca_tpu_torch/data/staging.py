"""A collated batch's way from host columns to device tensors.

- Memory: once CUDA is initialised in the process, :func:`empty` hands
  the collators ``torch.empty(..., pin_memory=True)`` blocks from
  PyTorch's caching host allocator as numpy arrays, on any thread; for a
  dtype torch lacks (strings, bytes, objects, dates) and in a process
  that has not touched CUDA it is ``np.empty``.  The array keeps its
  block alive through ``ndarray.base``, so a batch owns its blocks until
  it is dropped, and no batch aliases another.  A dropped block goes
  back to the allocator's cache, already pinned and faulted in; the
  allocator hands it out again only once every copy issued from it has
  finished.
- Narrowing: :func:`narrow_for_staging` narrows a training batch's
  float columns to ``stage_dtype`` (fp16 / bf16) by the sentinel rule of
  :func:`staging_sentinels`, and int64 columns to int32.
- The copy: :func:`to_device` copies every column to the device,
  without blocking the host from a pinned block's own tensor
  (:func:`pinned_tensor`) and pageable otherwise, and makes fp16 / bf16
  columns fp32 there.  A ``torch.from_numpy`` alias of a block would hide
  it from the allocator, which could then hand it to the next batch
  while the copy still reads it; no other module of the package issues a
  host-to-device copy without blocking.
- Recorded (:mod:`mca_tpu_torch.utils.trace`): the span ``data.copy``
  and its counters ``data.copied_bytes`` and ``data.pinned_bytes``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from mca_tpu_torch.utils import trace

#: ``stage_dtype`` values: fp32 copies the batches as collated
STAGE_DTYPES = ("fp32", "", None, "fp16", "bf16")
_NARROW = {"fp16": torch.float16, "bf16": torch.bfloat16}
# the reference's pad / missing marker, where a modality_config names none
_DEFAULT_PAD_TOKEN = -10000.0


def _torch_dtype(dtype: np.dtype) -> Optional[torch.dtype]:
    """``dtype``'s torch dtype; None where torch has none (strings,
    bytes, objects, dates)."""
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return None


def empty(shape: Sequence[int], dtype: Any) -> np.ndarray:
    """An uninitialised host array: a pinned block once CUDA is
    initialised, for a dtype torch has; else ``np.empty``."""
    dtype = np.dtype(dtype)
    if torch.cuda.is_initialized():
        as_torch = _torch_dtype(dtype)
        if as_torch is not None:
            return torch.empty(tuple(shape), dtype=as_torch, pin_memory=True).numpy()
    return np.empty(shape, dtype)


def pinned_tensor(x: Any) -> Optional[torch.Tensor]:
    """For a C-contiguous numpy column made by :func:`empty` in a pinned
    block (or a view of one, such as a row slice), a tensor view of the
    block with ``x``'s elements and shape; None for anything else, which
    is then copied as pageable memory."""
    if not isinstance(x, np.ndarray) or x.size == 0 or not x.flags.c_contiguous:
        return None
    top, block = x, x.base
    while isinstance(block, np.ndarray):
        top, block = block, block.base
    if (not isinstance(block, torch.Tensor) or top.dtype != x.dtype
            or not block.is_contiguous() or not block.is_pinned()):
        return None
    start = (x.ctypes.data - block.data_ptr()) // x.itemsize
    return block.reshape(-1)[start:start + x.size].view(x.shape)


def staging_sentinels(config) -> Dict[str, Optional[float]]:
    """Per modality, the float value that the model re-detects by exact
    equality on the device (so narrowing must keep it and must not round
    a live value onto it), or None where narrowing is always safe
    (``mca_tpu.train.staging_sentinels``): a ``matrix`` modality's
    ``pad_token`` (the PatchEncoder's patch mask); a ``sequence``
    modality's ``float(padding_idx)`` under a Tabular (-1) or
    SparseTabular (0) encoder (the value encoder's zeroing); None for
    ``embedded_sequence`` (an explicit attention mask) and token-id
    sequences."""
    enc = config.encoder_configs
    out: Dict[str, Optional[float]] = {}
    for m, c in config.modality_config.items():
        typ, e = c.get("type"), enc.get(m, {})
        if typ == "matrix":
            out[m] = float(e.get("pad_token", c.get("pad_token", _DEFAULT_PAD_TOKEN)))
        elif typ == "sequence" and e.get("type") == "TabularEncoder":
            out[m] = float(e.get("padding_idx", -1))
        elif typ == "sequence" and e.get("type") == "SparseTabularEncoder":
            out[m] = float(e.get("padding_idx", 0))
        else:
            out[m] = None
    return out


def _narrowed(x: float, dtype: torch.dtype) -> float:
    """``x`` as fp32, rounded to ``dtype`` and back."""
    return float(torch.tensor(x, dtype=torch.float32).to(dtype).float())


def _pad_representable(pad: float, dtype: torch.dtype) -> bool:
    return _narrowed(pad, dtype) == float(np.float32(pad))


def _nearest_distinct(pad: float, dtype: torch.dtype) -> float:
    """The closest ``dtype`` value that is not ``pad``, toward zero and of
    its sign: where a live value that narrowing rounds onto the sentinel
    is moved to."""
    p32 = np.float32(pad)
    if p32 == 0:
        return float(torch.finfo(dtype).smallest_normal)
    pn = _narrowed(p32, dtype)
    for k in range(12, 5, -1):  # finest first: the nearest distinct value
        c = _narrowed(p32 * np.float32(1 - 2.0**-k), dtype)
        if c != pn:
            return c
    raise ValueError(f"no {dtype} neighbour for pad {pad}")


def narrow_for_staging(batch, stage_dtype, sentinels=None):
    """The host's narrowing of a collated batch before its copy to the
    device (``mca_tpu.train.narrow_for_staging``); :func:`to_device`
    restores fp32 there.  ``fp32`` (or empty) returns ``batch`` as it is.

    ``fp16`` / ``bf16``: float32 columns become that type and int64
    columns int32 (torch tensors on the host); other columns pass.
    ``sentinels`` maps a modality to the float its device path detects
    by equality, or None (:func:`staging_sentinels`); without it every
    modality gets the reference's -10000.  Per modality, and the same
    for every batch: where the narrow type cannot hold the sentinel
    exactly (bf16 rounds -10000 to -9984), its float columns stay fp32;
    otherwise a live value that rounds onto the sentinel is moved one
    step toward zero (:func:`_nearest_distinct`), so no live entry
    becomes padding."""
    if stage_dtype in ("fp32", "", None):
        return batch
    nd = _NARROW[stage_dtype]
    out = {}
    for mod, cols in batch.items():
        pad = _DEFAULT_PAD_TOKEN if sentinels is None else sentinels.get(mod)
        if pad is None:
            pad_ok, bump = True, None  # no float equality on the device
        else:
            pad = float(np.float32(pad))
            pad_ok = _pad_representable(pad, nd)
            bump = _nearest_distinct(pad, nd) if pad_ok else None
        ncols = {}
        for name, x in cols.items():
            x = np.asarray(x)
            if x.dtype == np.float32:
                if not pad_ok:
                    ncols[name] = x  # never narrows
                    continue
                xt = torch.from_numpy(x)
                xn = xt.to(nd)
                if bump is not None:
                    collided = (xn.float() == pad) & (xt != pad)
                    if bool(collided.any()):
                        xn[collided] = bump
                ncols[name] = xn
            elif x.dtype == np.int64:
                ncols[name] = torch.from_numpy(x).to(torch.int32)
            else:
                ncols[name] = x
        out[mod] = ncols
    return out


def to_device(batch: Mapping[str, Mapping[str, Any]], device) -> dict:
    """A collated batch (numpy arrays, or the tensors of
    :func:`narrow_for_staging`) on ``device``; fp16 / bf16 columns are
    copied narrow and become fp32 there.  A column held in a pinned host
    block goes to a CUDA device without blocking the host, issued on the
    block's own tensor on the current stream: the kernels that read it
    follow the copy in stream order, and the allocator keeps the block
    until the copy has read it.  Other columns are copied pageable.
    Recorded as ``data.copy``, with the counters ``data.copied_bytes``
    and ``data.pinned_bytes`` (of them, those copied from pinned
    blocks)."""
    cuda = torch.device(device).type == "cuda"
    out = {}
    copied = from_pinned = 0
    with trace.span("data.copy"):
        for m, fields in batch.items():
            out[m] = {}
            for k, v in fields.items():
                src = pinned_tensor(v) if cuda else None
                if src is not None:
                    t = src.to(device, non_blocking=True)
                    from_pinned += t.nbytes
                else:
                    t = torch.as_tensor(v).to(device)
                copied += t.nbytes
                out[m][k] = t.float() if t.dtype in (torch.float16, torch.bfloat16) else t
        trace.count("data.copied_bytes", copied)
        trace.count("data.pinned_bytes", from_pinned)
    return out
