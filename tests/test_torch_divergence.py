"""The port's training loop honours ``halt_on_nan`` and refuses the
training keys it does not implement yet, as the JAX package's does.

Divergence: a misconfigured ``lr: inf`` with ``clip: 0``, as in
``tests/test_divergence.py``: the warm-up schedule's 0 * inf makes the
first update NaN, so every later step's ``grad_norm`` is NaN.
"""

import math

import numpy as np
import pytest

from mca_tpu.data.synthetic import tiny_config
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.data.synthetic import make_tcga_like

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}


def _cfg(**overrides):
    return training_config_from_dict(
        tiny_config("tcga", widths=WIDTHS, batch_size=8, num_warmup_steps=1, **overrides)
    )


def _rows():
    return make_tcga_like(16, widths=WIDTHS, p_missing=0.2, seed=0)


def test_halt_on_nan_raises_divergence_error():
    cfg = _cfg(lr=float("inf"), clip=0.0)
    logged = []
    with pytest.raises(port_train.DivergenceError, match="grad_norm is nan at step 1"):
        port_train.train(cfg, device="cpu", steps=4, rows=_rows(), log=logged.append)
    # the diverged step reached the log before the halt
    assert [m["step"] for m in logged] == [0, 1]
    assert math.isfinite(logged[0]["grad_norm"]) and not math.isfinite(logged[1]["grad_norm"])
    assert issubclass(port_train.DivergenceError, RuntimeError)


def test_halt_on_nan_disabled_runs_to_completion():
    cfg = _cfg(lr=float("inf"), clip=0.0)
    cfg.halt_on_nan = False
    history = port_train.train(cfg, device="cpu", steps=3, rows=_rows())
    assert [m["step"] for m in history] == [0, 1, 2]
    assert not np.isfinite(history[-1]["grad_norm"])


@pytest.mark.parametrize(
    "key,value,error",
    [
        ("grad_accum", 2, NotImplementedError),
        ("grad_accum", 4, NotImplementedError),
        ("moment_dtype", "bf16", NotImplementedError),
        ("moment_dtype", "fp16", ValueError),
    ],
)
def test_unported_training_keys_are_refused(key, value, error):
    cfg = _cfg(**{key: value})
    with pytest.raises(error, match=key):
        port_train.build_trainer(cfg, "cpu")
    with pytest.raises(error, match=key):
        port_train.train(cfg, device="cpu", steps=1, rows=_rows())


def test_default_training_keys_are_accepted():
    cfg = _cfg(grad_accum=1, moment_dtype="fp32")
    port_train.check_training_keys(cfg)
    port_train.check_training_keys(_cfg())
