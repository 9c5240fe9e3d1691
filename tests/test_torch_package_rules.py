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
from mca_tpu_torch import infer as port_infer
from mca_tpu_torch import probe as port_probe
from mca_tpu_torch import train as port_train
from mca_tpu_torch.serve import EmbeddingService

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "mca_tpu", "einops", "ml_dtypes")


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
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for module in ("data/dataset.py", "utils/logging.py", "eval_metrics.py",
                   "checkpoint.py", "train.py", "infer.py", "probe.py", "metrics.py",
                   "models/pool.py", "models/eao.py", "encoders.py", "data/collators.py",
                   "data/synthetic.py", "data/staging.py", "serve.py", "tools/__init__.py",
                   "tools/profile_train.py", "tools/profile_serve.py", "models/moe.py",
                   "tools/moe_stats.py", "native/__init__.py", "parallel/__init__.py",
                   "parallel/multihost.py", "parallel/mesh.py", "parallel/collectives.py",
                   "parallel/sharding.py", "parallel/launch.py",
                   "ops/segmented_attention.py", "tools/attention_maps.py",
                   "tools/import_checkpoint.py", "data/preprocess_tcga.py",
                   "data/preprocess_cmu.py", "tools/reproduce.py", "tools/gen_corpus.py",
                   "tools/sweep.py"):
        assert f"mca_tpu_torch/{module}" in names, module
    bad = [
        (f.relative_to(ROOT).as_posix(), mod)
        for f in files
        for mod in _imported_modules(f)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_only_staging_copies_to_the_device_without_blocking():
    """No module of the port but ``data/staging.py`` calls ``.to(...,
    non_blocking=...)``: a host-to-device copy that does not block reads
    its source after the call returns, so only the module that owns the
    pinned blocks may issue one (``copy_`` back to the host is not such a
    call)."""
    files = sorted((ROOT / "mca_tpu_torch").rglob("*.py"))
    found = [
        (f.relative_to(ROOT).as_posix(), node.lineno)
        for f in files
        for node in ast.walk(ast.parse(f.read_text()))
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
        and node.func.attr == "to" and any(k.arg == "non_blocking" for k in node.keywords)
    ]
    assert [path for path, _ in found] == ["mca_tpu_torch/data/staging.py"], found


def _module_level_imports(tree):
    """Imports outside every function body of a module."""
    todo = list(ast.iter_child_nodes(tree))
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        todo.extend(ast.iter_child_nodes(node))


def test_hf_packages_are_imported_inside_functions_only():
    """The card has neither ``datasets`` nor ``pyarrow`` (nor
    ``safetensors``, ``wandb``, ``pandas`` or ``h5py``): the loader and
    the preprocessors import them where they read or write a dataset, so
    the port imports without them."""
    files = sorted((ROOT / "mca_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    top = [
        (f.relative_to(ROOT).as_posix(), mod)
        for f in files
        for mod in _module_level_imports(ast.parse(f.read_text()))
        if mod.split(".")[0] in ("datasets", "pyarrow", "safetensors", "wandb", "pandas",
                                 "h5py")
    ]
    assert top == []
    inside = {mod.split(".")[0] for mod in _imported_modules(ROOT / "mca_tpu_torch/data/dataset.py")}
    assert {"datasets", "pyarrow"} <= inside
    for module, packages in (("preprocess_tcga", {"datasets", "pandas"}),
                             ("preprocess_cmu", {"datasets", "h5py"})):
        path = ROOT / f"mca_tpu_torch/data/{module}.py"
        assert packages <= {mod.split(".")[0] for mod in _imported_modules(path)}, module


def test_service_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cfg = training_config_from_dict(tiny_config("tcga", batch_size=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingService(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingService(cfg, restart="no-such-checkpoint")


def test_train_entry_point_defaults_to_cuda_and_raises_without_it(tmp_path):
    import yaml

    for fn in (port_train.train, port_train.build_trainer):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cfg = training_config_from_dict(tiny_config("tcga", batch_size=2))
    cfg.output_dir = str(tmp_path / "out")
    rows = port_train.synthetic_rows(cfg, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.train(cfg, rows=rows)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.build_trainer(cfg)
    cfg_path = tmp_path / "tcga.yaml"
    cfg_path.write_text(yaml.safe_dump({**yaml.safe_load(open(ROOT / "configs/tcga_mca.yaml")),
                                        "output_dir": str(tmp_path / "cli")}))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main([str(cfg_path), "--synthetic", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main([str(cfg_path)])  # the dataset: path is not read first
    assert not (tmp_path / "out").exists()


def test_infer_and_probe_entry_points_default_to_cuda(tmp_path):
    """``infer`` and ``probe`` (functions and CLIs) run on the GPU unless
    the CPU is asked for, and raise without one before reading a file."""
    import yaml

    for fn in (port_infer.infer, port_infer.build_inference_model, port_probe.probe):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cfg_path = tmp_path / "infer.yaml"
    cfg_path.write_text(yaml.safe_dump({
        **yaml.safe_load(open(ROOT / "configs/tcga_mca.yaml")),
        "restart": str(tmp_path / "no-such-checkpoint"), "output_dir": str(tmp_path / "i")}))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_infer.main([str(cfg_path), "--synthetic", "8"])
    probe_path = tmp_path / "probe.yaml"
    probe_path.write_text(yaml.safe_dump({
        **yaml.safe_load(open(ROOT / "configs/tcga_probe.yaml")),
        "embedding_dir": str(tmp_path / "no-such-dir"), "output_dir": str(tmp_path / "p")}))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_probe.main([str(probe_path)])


def test_cmu_entry_points_default_to_cuda(tmp_path):
    """CMU_config1 through every entry point this slice touched (serve,
    train, infer and the two profiling tools): each runs on the GPU
    unless the CPU is asked for, and raises without one."""
    import yaml

    from mca_tpu_torch.tools import profile_serve, profile_train

    assert inspect.signature(EmbeddingService).parameters["device"].default == "cuda"
    for fn in (port_train.train, port_train.build_trainer, port_infer.infer):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    cmu = yaml.safe_load(open(ROOT / "configs/cmu_mca.yaml"))
    cfg_path = tmp_path / "cmu.yaml"
    cfg_path.write_text(yaml.safe_dump({**cmu, "output_dir": str(tmp_path / "out"),
                                        "restart": str(tmp_path / "no-such-checkpoint")}))
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingService(training_config_from_dict(cmu))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.main([str(cfg_path), "--synthetic", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        port_infer.main([str(cfg_path), "--synthetic", "4"])
    for tool in (profile_train, profile_serve):
        with pytest.raises(SystemExit, match="CUDA"):
            tool.main([str(cfg_path)])


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
