"""The port's package rules: it imports no JAX and nothing of the JAX
package, its entry points run on the GPU unless the CPU is asked for,
and its kernel wrappers never fall back from the kernel to the plain
version."""

import ast
import inspect
import pathlib

import numpy as np
import pytest
import torch

from mca_tpu.data.synthetic import tiny_config
from mca_tpu_torch import _build
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.ops import flash_attention as port_flash
from mca_tpu_torch.ops import fused_ff as port_ff
from mca_tpu_torch import train as port_train
from mca_tpu_torch.serve import EmbeddingService

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mca_tpu")


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_or_jax_package_imports():
    files = sorted((ROOT / "mca_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [
        (f.relative_to(ROOT).as_posix(), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_service_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cfg = training_config_from_dict(tiny_config("tcga", batch_size=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingService(cfg)


def test_train_entry_point_defaults_to_cuda_and_raises_without_it():
    for fn in (port_train.train, port_train.build_trainer):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cfg = training_config_from_dict(tiny_config("tcga", batch_size=2))
    rows = port_train.synthetic_rows(cfg, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.train(cfg, steps=1, rows=rows)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main(["configs/tcga_mca.yaml", "--synthetic", "8", "--steps", "1"])


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_wrappers_raise_where_no_kernel_can_launch():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused, never computed by the plain version."""
    t = 70
    before = (port_flash.launches, port_ff.launches)
    mask = np.zeros((t, t), bool)
    with pytest.raises(RuntimeError, match="not meta"):
        port_flash.flash_attention(
            _meta(1, 2, t, 64), _meta(1, 2, t, 64), _meta(1, 2, t, 64),
            mask, None, 0.125,
        )
    with pytest.raises(RuntimeError, match="not meta"):
        port_ff.geglu_ff(_meta(5, 512), _meta(2816, 512), _meta(512, 1408))
    assert (port_flash.launches, port_ff.launches) == before
    bwd_before = dict(port_flash.bwd_launches)
    q = _meta(1, 2, t, 64)
    for impl in ("fused", "split"):
        with pytest.raises(RuntimeError, match="not meta"):
            port_flash.flash_attention_backward(
                q, q, q, mask, None, q, _meta(1, 2, t, dtype=torch.float32), q,
                0.125, impl,
            )
    assert port_flash.bwd_launches == bwd_before


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """Without the CUDA toolkit the build raises instead of leaving the
    caller without a kernel."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()


@pytest.mark.parametrize("name", _build.KERNELS)
def test_kernel_sources_exist_with_c_entry_points(name):
    src = (_build.CSRC / f"{name}.cu").read_text()
    assert f'extern "C" int mca_{name}(' in src
    assert "mca_cuda_error_string" in src
    assert "return int(cudaGetLastError());" in src
    assert _build.library_path(name).name.startswith(f"lib{name}-")
