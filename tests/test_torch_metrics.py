"""``mca_tpu_torch.metrics`` against ``mca_tpu.metrics``: the port's
numpy copy gives the JAX package's numbers on seeded inputs (to 1e-12;
the same float64 arithmetic gives the same bits)."""

import numpy as np
import pytest

from mca_tpu import metrics as jax_metrics
from mca_tpu_torch import metrics


def _inputs(seed, n=40, d=8, classes=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x + 0.5 * rng.normal(size=(n, d))).astype(np.float32)
    logits = rng.normal(size=(n, classes)).astype(np.float32)
    target = rng.integers(0, classes, size=n)
    binary = rng.integers(0, 2, size=(n, classes))
    return x, y, logits, target, binary


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
        return
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("norm", [True, False])
def test_alignment_and_uniformity(seed, norm):
    x, y, *_ = _inputs(seed)
    _same(metrics.alignment(x, y, norm=norm), jax_metrics.alignment(x, y, norm=norm))
    _same(metrics.alignment(x, y, alpha=3, norm=norm),
          jax_metrics.alignment(x, y, alpha=3, norm=norm))
    _same(metrics.uniformity(x, norm=norm), jax_metrics.uniformity(x, norm=norm))
    _same(metrics.uniformity(x, t=1.5, norm=norm), jax_metrics.uniformity(x, t=1.5, norm=norm))


def test_metric_accumulator():
    x, y, *_ = _inputs(2)
    a, b = metrics.MetricAccumulator(), jax_metrics.MetricAccumulator()
    assert not a and not b
    for acc in (a, b):
        acc.update(x[:20], y[:20])
        acc.update(x[20:], y[20:])
    assert a and b
    _same(a.compute_uniformity(), b.compute_uniformity())
    _same(a.compute_alignment(), b.compute_alignment())
    a.reset()
    assert not a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_metrics(seed):
    x, y, *_ = _inputs(seed)
    mask = np.random.default_rng(seed).random(len(x)) < 0.7
    _same(metrics.rank_metrics(x, y), jax_metrics.rank_metrics(x, y))
    _same(metrics.rank_metrics(x, y, mask=mask), jax_metrics.rank_metrics(x, y, mask=mask))
    assert metrics.get_rank_metrics is metrics.rank_metrics


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_binary_metrics(seed):
    _, _, logits, _, binary = _inputs(seed)
    _same(metrics.binary_metrics(logits, binary), jax_metrics.binary_metrics(logits, binary))
    _same(metrics.binary_metrics(logits, binary, threshold=0.3),
          jax_metrics.binary_metrics(logits, binary, threshold=0.3))
    scores = np.round(logits[:, 0], 1)  # ties, averaged in the rank statistic
    t = binary[:, 0]
    _same(metrics.binary_auroc(scores, t), jax_metrics.binary_auroc(scores, t))
    _same(metrics.binary_auprc(scores, t), jax_metrics.binary_auprc(scores, t))
    assert np.isnan(metrics.binary_auroc(scores, np.zeros_like(t)))
    assert np.isnan(metrics.binary_auprc(scores, np.zeros_like(t)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multiclass_metrics_and_pearson(seed):
    _, _, logits, target, _ = _inputs(seed)
    _same(metrics.multiclass_metrics(logits, target, 3),
          jax_metrics.multiclass_metrics(logits, target, 3))
    # a class never seen: skipped by the one-vs-rest AUROC, as in JAX
    _same(metrics.multiclass_metrics(logits, np.minimum(target, 1), 3),
          jax_metrics.multiclass_metrics(logits, np.minimum(target, 1), 3))
    _same(metrics.pearson_r(logits[:, 0], logits[:, 1]),
          jax_metrics.pearson_r(logits[:, 0], logits[:, 1]))
