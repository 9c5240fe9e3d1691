"""The C++ collate (``fastcollate.cc``) and its plain numpy versions.

The port's own copy of ``mca_tpu/native``: :func:`pad_rows`,
:func:`pad_rows_fill` and :func:`pad_seq2d` pad a batch of
variable-length rows in one C call each (the collators of
:mod:`mca_tpu_torch.data.collators` call them).  The library is built
with ``g++`` at first use into ``mca_tpu_torch/_build/``, under a name
hashed from the source, the flags and the machine, as ``_build.py``
builds the CUDA kernels.  A failed build raises with the compiler's
output: there is no quiet numpy fallback.

``pad_rows_plain``, ``pad_rows_fill_plain`` and ``pad_seq2d_plain`` are
the same functions in numpy, the reference the tests hold the C entries
to, bit for bit.

The C entries write into :func:`mca_tpu_torch.data.staging.empty`'s
arrays: pinned blocks once CUDA is initialised, plain numpy arrays
elsewhere.  :func:`pad_seq2d` splits its rows over
:func:`seq2d_threads` threads, by the bytes it writes.

Both paths of :func:`pad_seq2d` refuse what the C code would read past
or cut silently: a row longer than ``pad_len`` (the collator truncates
first unless ``truncate: false``) and a non-empty row whose width is not
``width``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from mca_tpu_torch.data import staging

SRC = Path(__file__).resolve().parent / "fastcollate.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
#: bytes of output a thread of :func:`pad_seq2d` takes at least (a CMU
#: batch's COVAREP and OpenFace columns are 28 and 82 MB)
THREAD_BYTES = 2 << 20
#: a CMU batch's collate on one H100 machine's 8-core host read 13.0 ms
#: at 4 threads, 15.2 at 2 and 17.7 at 8; on another 7.9-9.0 at 4 and
#: 8.6-8.8 at 8: more than 4 gained nothing
MAX_THREADS = 4

_LIB: Optional[ctypes.CDLL] = None


def compiler_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the C++ collate (mca_tpu_torch/native) needs it")
    return found


def library_path() -> Path:
    h = hashlib.sha1(SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS + (platform.machine(),)).encode())
    return BUILD_DIR / f"libfastcollate-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is there; raises with the
    compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([compiler_path(), *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"C++ collate build failed (exit {proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded library, built if needed, its entry points typed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        i64, f32, vp = ctypes.c_int64, ctypes.c_float, ctypes.c_void_p
        pp = ctypes.POINTER(vp)
        lib.pad_rows_f32.argtypes = [pp, vp, i64, i64, f32, vp, vp]
        lib.pad_rows_fill_f32.argtypes = [pp, vp, i64, i64, f32, vp]
        lib.pad_seq2d_f32.argtypes = [pp, vp, i64, i64, i64, f32, ctypes.c_int, vp, vp, i64]
        for fn in (lib.pad_rows_f32, lib.pad_rows_fill_f32, lib.pad_seq2d_f32):
            fn.restype = None
        _LIB = lib
    return _LIB


def _flat_rows(rows: Sequence) -> List[Optional[np.ndarray]]:
    return [None if r is None else np.ascontiguousarray(np.asarray(r, np.float32).reshape(-1))
            for r in rows]


def _pointers(rows: List[Optional[np.ndarray]]):
    """``(row pointers, lengths)`` of C-contiguous f32 rows; the caller
    keeps ``rows`` alive across the C call."""
    ptrs = (ctypes.c_void_p * len(rows))()
    lens = np.zeros(len(rows), np.int64)
    for i, r in enumerate(rows):
        if r is not None and r.shape[0]:
            ptrs[i] = r.ctypes.data
            lens[i] = r.shape[0]
    return ptrs, lens


def pad_rows(rows: Sequence, pad_len: int, pad_value: float,
             with_mask: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """1-D rows (None for a missing one) -> ``[n, pad_len]`` f32 padded
    with ``pad_value``, each row cut to ``pad_len``, and the int64 mask
    ``out == pad_value`` (None without ``with_mask``)."""
    flat = _flat_rows(rows)
    ptrs, lens = _pointers(flat)
    out = staging.empty((len(flat), pad_len), np.float32)
    mask = staging.empty((len(flat), pad_len), np.int64) if with_mask else None
    library().pad_rows_f32(ptrs, lens.ctypes.data, len(flat), pad_len, float(pad_value),
                           out.ctypes.data, None if mask is None else mask.ctypes.data)
    return out, mask


def pad_rows_fill(rows: Sequence, pad_len: int, fill: float) -> np.ndarray:
    """1-D rows -> ``[n, pad_len]`` f32 padded with ``fill``, no mask."""
    flat = _flat_rows(rows)
    ptrs, lens = _pointers(flat)
    out = staging.empty((len(flat), pad_len), np.float32)
    library().pad_rows_fill_f32(ptrs, lens.ctypes.data, len(flat), pad_len, float(fill),
                                out.ctypes.data)
    return out


def _seq2d_rows(rows: Sequence, pad_len: int, width: int) -> List[Optional[np.ndarray]]:
    """``[T, width]`` f32 C-contiguous rows (None for a missing or
    empty one); raises ``ValueError`` for a row longer than ``pad_len``
    or a non-empty row of another width."""
    out: List[Optional[np.ndarray]] = []
    for i, r in enumerate(rows):
        if r is None or np.shape(r)[0] == 0:
            out.append(None)
            continue
        r = np.ascontiguousarray(r, np.float32)
        if r.ndim != 2 or r.shape[1] != width:
            raise ValueError(f"row {i} has shape {r.shape}, expected [T, {width}]")
        if r.shape[0] > pad_len:
            raise ValueError(
                f"row {i} has {r.shape[0]} tokens, more than pad_len {pad_len} "
                "(truncate: true cuts it)"
            )
        out.append(r)
    return out


def seq2d_threads(nbytes: int) -> int:
    """Threads for a :func:`pad_seq2d` call that writes ``nbytes``: one
    a :data:`THREAD_BYTES`, at most :data:`MAX_THREADS` and the cores
    this process may run on; one under twice :data:`THREAD_BYTES`."""
    return max(1, min(MAX_THREADS, len(os.sched_getaffinity(0)), nbytes // THREAD_BYTES))


def pad_seq2d(rows: Sequence, pad_len: int, width: int, fill: float,
              clean: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """``[T_i, width]`` rows -> ``[n, pad_len, width]`` f32 padded with
    ``fill`` and the bool length mask (True = padding); with ``clean``,
    NaN -> 0 and +-Inf -> +-FLT_MAX."""
    checked = _seq2d_rows(rows, pad_len, width)
    ptrs, lens = _pointers(checked)
    out = staging.empty((len(checked), pad_len, width), np.float32)
    mask = staging.empty((len(checked), pad_len), np.bool_)
    library().pad_seq2d_f32(ptrs, lens.ctypes.data, len(checked), pad_len, width,
                            float(fill), int(bool(clean)), out.ctypes.data, mask.ctypes.data,
                            seq2d_threads(out.nbytes))
    return out, mask


def pad_rows_plain(rows: Sequence, pad_len: int, pad_value: float,
                   with_mask: bool = True) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """:func:`pad_rows` in numpy."""
    out = np.full((len(rows), pad_len), pad_value, np.float32)
    for i, r in enumerate(_flat_rows(rows)):
        if r is not None:
            r = r[:pad_len]
            out[i, : r.shape[0]] = r
    return out, (out == np.float32(pad_value)).astype(np.int64) if with_mask else None


def pad_rows_fill_plain(rows: Sequence, pad_len: int, fill: float) -> np.ndarray:
    """:func:`pad_rows_fill` in numpy."""
    return pad_rows_plain(rows, pad_len, fill, with_mask=False)[0]


def pad_seq2d_plain(rows: Sequence, pad_len: int, width: int, fill: float,
                    clean: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`pad_seq2d` in numpy."""
    checked = _seq2d_rows(rows, pad_len, width)
    tokens = np.full((len(checked), pad_len, width), fill, np.float32)
    mask = np.ones((len(checked), pad_len), bool)
    for i, r in enumerate(checked):
        if r is not None:
            t = r.shape[0]
            tokens[i, :t] = np.nan_to_num(r) if clean else r
            mask[i, :t] = False
    return tokens, mask
