"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``_build/lib<name>-<hash>.so`` inside the package.  The hash covers the
source, the shared headers and the flags, so an edited source is never
served from a stale library.  ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for them together.

The ptxas report (registers, shared memory, spills per kernel) is kept
beside each library as ``.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
KERNELS = ("flash_fwd", "geglu_ff", "flash_bwd", "flash_bwd_dq", "flash_bwd_dkv")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are compiled from "
        "mca_tpu_torch/csrc on a machine with the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every missing library in ``names`` in parallel.

    Returns ``{name: ptxas report}``; raises with nvcc's output when a
    build fails.
    """
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {
        name: library_path(name).with_suffix(".log").read_text()
        if library_path(name).with_suffix(".log").exists() else ""
        for name in names
    }


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library for ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.mca_cuda_error_string.restype = ctypes.c_char_p
        lib.mca_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return _LIBS[name]


def function(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``mca_<name>`` of ``csrc/<name>.cu``, typed
    once: it returns a ``cudaError_t`` as int."""
    if name not in _FUNCS:
        fn = getattr(library(name), f"mca_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _FUNCS[name] = fn
    return _FUNCS[name]


def check(name: str, err: int) -> None:
    """Raise on a non-zero ``cudaError_t`` from the entry point of
    ``csrc/<name>.cu`` (a refused launch never runs, and a later
    synchronise would not report it)."""
    if err != 0:
        msg = library(name).mca_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch: CUDA error {err} ({msg})")
