"""The port's training loop honours ``halt_on_nan`` and refuses the
training keys it cannot train as asked, as the JAX package's does;
``train`` and ``infer`` refuse a mesh larger than the world (one process
here) and the mesh options not ported yet (GPipe's ``mesh_pipe``, expert
parallelism).

Divergence: a misconfigured ``lr: inf`` with ``clip: 0``, as in
``tests/test_divergence.py``: the warm-up schedule's 0 * inf makes the
first update NaN, so every later step's ``grad_norm`` is NaN.  16 rows
split 0.25 leave 12 train rows: one step of 8 an epoch.
"""

import json
import math
import os

import numpy as np
import pytest
import torch

from mca_tpu.data.synthetic import tiny_config
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.data.synthetic import make_tcga_like

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores, where per-worker thread pools
    oversubscribe them and slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path=None, **overrides):
    cfg = training_config_from_dict(
        tiny_config("tcga", widths=WIDTHS, batch_size=8, num_warmup_steps=1, **overrides)
    )
    if tmp_path is not None:
        cfg.output_dir = str(tmp_path / "out")
    return cfg


def _rows():
    return make_tcga_like(16, widths=WIDTHS, p_missing=0.2, seed=0)


def test_halt_on_nan_raises_divergence_error(tmp_path):
    cfg = _cfg(tmp_path, lr=float("inf"), clip=0.0, epochs=4)
    logged = []
    with pytest.raises(port_train.DivergenceError, match="grad_norm is nan at step 2"):
        port_train.train(cfg, device="cpu", rows=_rows(), log=logged.append)
    # the diverged step reached the log before the halt
    assert [m["step"] for m in logged] == [1, 2]
    assert math.isfinite(logged[0]["grad_norm"]) and not math.isfinite(logged[1]["grad_norm"])
    assert issubclass(port_train.DivergenceError, RuntimeError)


def test_halt_on_nan_disabled_runs_to_completion(tmp_path):
    cfg = _cfg(tmp_path, lr=float("inf"), clip=0.0, epochs=3)
    cfg.halt_on_nan = False
    out = port_train.train(cfg, device="cpu", rows=_rows())
    with open(os.path.join(out, "metrics.jsonl")) as f:
        history = [json.loads(line) for line in f]
    assert [m["step"] for m in history] == [1, 2, 3]
    assert not np.isfinite(history[-1]["grad_norm"])
    assert not os.path.exists(os.path.join(out, "diverged"))


@pytest.mark.parametrize(
    "key,value,error",
    [
        ("grad_accum", 3, ValueError),  # does not divide batch_size 8
        ("stage_dtype", "fp8", ValueError),  # fp16 / bf16 staging is ported
        ("moment_dtype", "fp16", ValueError),
        # a mesh larger than the world of one process (GPipe's pipe axis too)
        ("mesh_pipe", 2, ValueError),
        ("mesh_pipe", 5, ValueError),
        ("mesh_model", 2, ValueError),
        ("mesh_data", 2, ValueError),
        ("mesh_data", 4, ValueError),
    ],
)
def test_unported_training_keys_are_refused(key, value, error, tmp_path):
    cfg = _cfg(tmp_path, **{key: value})
    with pytest.raises(error, match=key):
        port_train.build_trainer(cfg, "cpu")
    with pytest.raises(error, match=key):
        port_train.train(cfg, device="cpu", rows=_rows())
    assert not os.path.exists(cfg.output_dir)


@pytest.mark.parametrize("key", ["mesh_model", "mesh_data"])
def test_infer_refuses_a_mesh_before_reading_anything(key, tmp_path):
    """A mesh larger than the world; ``infer`` ignores ``mesh_pipe``, as
    the JAX package's does."""
    from mca_tpu_torch import infer as port_infer

    cfg = _cfg(tmp_path, **{key: 2})
    cfg.restart = str(tmp_path / "no-such-checkpoint")
    with pytest.raises(ValueError, match=f"{key}=2 .*the world has 1"):
        port_infer.infer(cfg, device="cpu", rows=_rows())
    assert not os.path.exists(cfg.output_dir)
    cfg = _cfg(tmp_path, mesh_pipe=2)
    cfg.restart = str(tmp_path / "no-such-checkpoint")
    with pytest.raises(FileNotFoundError, match="no-such-checkpoint"):
        port_infer.infer(cfg, device="cpu", rows=_rows())


@pytest.mark.parametrize("entry", ["build_trainer", "train"])
def test_expert_parallelism_is_refused(entry, tmp_path):
    """``moe_experts`` with ``mesh_model > 1`` trains (expert parallelism);
    on one process the mesh is larger than the world, and that is what
    refuses it, before anything is read."""
    cfg = _cfg(tmp_path, moe_experts=2, mesh_model=2)
    with pytest.raises(ValueError, match="mesh_model=2 needs 2 ranks; the world has 1"):
        if entry == "train":
            port_train.train(cfg, device="cpu", rows=_rows())
        else:
            port_train.build_trainer(cfg, "cpu")
    assert not os.path.exists(cfg.output_dir)


def test_default_training_keys_are_accepted():
    cfg = _cfg(grad_accum=1, moment_dtype="fp32")
    port_train.check_training_keys(cfg)
    port_train.check_training_keys(_cfg())
    for accepted in (dict(grad_accum=2), dict(grad_accum=8), dict(moment_dtype="bf16"),
                     dict(steps_per_call=32, flat_state=True, fuse_optimizer=False),
                     dict(stage_dtype="fp32", trace_dir=""), dict(stage_dtype="bf16"),
                     dict(stage_dtype="fp16"), dict(mesh_data=0, mesh_model=1),
                     dict(mesh_data=1, mesh_model=1, fsdp=True),
                     dict(mesh_data=2, mesh_model=2, fsdp=True, seq_shard=True)):
        port_train.check_training_keys(_cfg(**accepted))
