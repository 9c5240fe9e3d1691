"""Host memory for collated batches: pinned blocks from PyTorch's
caching host allocator, written once and read by the card's DMA.

Inside :func:`collating` on a thread (``BatchedLoader`` wraps each of its
collator calls in it), and once CUDA is initialised in the process,
:func:`empty` hands out ``torch.empty(..., pin_memory=True)`` blocks as
numpy arrays.  The array keeps its block alive through ``ndarray.base``,
so a batch owns its blocks until it is dropped, and no batch aliases
another.  A dropped block goes back to the allocator's cache, already
pinned and faulted in; the allocator hands it out again only once every
copy issued from it has finished.  Elsewhere (on the CPU, in a process
that has not touched CUDA, outside :func:`collating`, and for a dtype
torch lacks, such as a string label's) :func:`empty` is ``np.empty``.

:func:`pinned_tensor` finds the block under a column, so that
``train.to_device`` can issue the copy on the allocator's own tensor:
a ``torch.from_numpy`` alias would hide the block from the allocator,
which could then hand it to the next batch while the copy still reads
it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Iterator, Optional, Sequence

import numpy as np
import torch

_state = threading.local()


@contextmanager
def collating() -> Iterator[None]:
    """On this thread, inside the block, :func:`empty` pins once CUDA is
    initialised."""
    before = getattr(_state, "on", False)
    _state.on = True
    try:
        yield
    finally:
        _state.on = before


def _torch_dtype(dtype: np.dtype) -> Optional[torch.dtype]:
    """``dtype``'s torch dtype; None where torch has none (strings,
    bytes, objects, dates)."""
    try:
        return torch.from_numpy(np.empty(0, dtype)).dtype
    except TypeError:
        return None


def empty(shape: Sequence[int], dtype: Any) -> np.ndarray:
    """An uninitialised host array: a pinned block inside
    :func:`collating` once CUDA is initialised, for a dtype torch has;
    else ``np.empty``."""
    dtype = np.dtype(dtype)
    if getattr(_state, "on", False) and torch.cuda.is_initialized():
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
