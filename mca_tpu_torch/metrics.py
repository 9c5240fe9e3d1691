"""Embedding-space + probe metrics: a verbatim numpy copy of
``mca_tpu/metrics.py``.  The probe computes them on the host after
each epoch, as the JAX package does; the port keeps its own copy so
that it imports nothing of the JAX package.

- :func:`alignment` / :func:`uniformity` — Wang & Isola (2020) metrics
  (ref utils/metrics.py:20-33), with the same optional L2-normalise.
- :class:`MetricAccumulator` — concat-state accumulator replacing the
  torchmetrics ``dist_reduce_fx="cat"`` wrappers (ref :37-70).
- :func:`rank_metrics` — retrieval median-rank / R@1/5/10 of each
  modality's embeddings against the fusion embeddings.  The reference's
  version was broken as-committed (mis-matched callsite
  ``lp_accel_gpu.py:72-76``); this is the working capability.
- probe metrics: accuracy/precision/recall/specificity/F1/AUROC/AUPRC/
  confusion matrix for binary & multiclass heads, plus Pearson r —
  numpy implementations of the torchmetrics suite used by
  ``lp_accel_gpu.py:121-148``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Wang & Isola alignment / uniformity
# ---------------------------------------------------------------------------


def _l2norm(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    return x / np.maximum(n, 1e-12)


def alignment(
    x: np.ndarray, y: np.ndarray, alpha: float = 2, norm: bool = True
) -> float:
    x = _l2norm(x) if norm else x
    y = _l2norm(y) if norm else y
    return float(
        (np.linalg.norm(x - y, axis=1) ** alpha).mean()
    )


def uniformity(x: np.ndarray, t: float = 2, norm: bool = True) -> float:
    x = _l2norm(x) if norm else x
    sq = np.square(x[:, None, :] - x[None, :, :]).sum(-1)
    iu = np.triu_indices(len(x), k=1)
    sq_pdist = sq[iu]
    return float(np.log(np.exp(-t * sq_pdist).mean()))


class MetricAccumulator:
    """Concat embeddings across eval batches, compute at epoch end."""

    def __init__(self):
        self._preds: List[np.ndarray] = []
        self._targets: List[np.ndarray] = []

    def update(
        self, preds, targets=None
    ) -> None:
        self._preds.append(np.asarray(preds))
        if targets is not None:
            self._targets.append(np.asarray(targets))

    def compute_uniformity(self, t: float = 2, norm: bool = False):
        return uniformity(np.concatenate(self._preds), t, norm)

    def compute_alignment(self, alpha: float = 2, norm: bool = False):
        return alignment(
            np.concatenate(self._preds),
            np.concatenate(self._targets),
            alpha,
            norm,
        )

    def reset(self) -> None:
        self._preds.clear()
        self._targets.clear()

    def __bool__(self) -> bool:
        return bool(self._preds)


# ---------------------------------------------------------------------------
# Retrieval / rank metrics
# ---------------------------------------------------------------------------


def rank_metrics(
    embeddings: np.ndarray,
    targets: np.ndarray,
    mask: Optional[np.ndarray] = None,
) -> Dict[str, float]:
    """Median rank + R@1/5/10 of each row's true target.

    ``embeddings[i]`` should retrieve ``targets[i]``: rank = number of
    targets with strictly higher cosine than the true one (0 = best).
    """
    if mask is not None:
        idx = np.nonzero(np.asarray(mask))[0]
    else:
        idx = np.arange(len(embeddings))
    emb = _l2norm(np.asarray(embeddings[idx], np.float32))
    tgt = _l2norm(np.asarray(targets, np.float32))
    sims = emb @ tgt.T  # [n, N]
    true_sims = sims[np.arange(len(idx)), idx]
    ranks = (sims > true_sims[:, None]).sum(axis=1)
    return {
        "median_rank": float(np.median(ranks)),
        "r1": float((ranks == 0).mean()),
        "r5": float((ranks < 5).mean()),
        "r10": float((ranks < 10).mean()),
    }


# ---------------------------------------------------------------------------
# Probe metric suite (binary / multiclass / regression)
# ---------------------------------------------------------------------------


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def _binary_counts(pred: np.ndarray, target: np.ndarray):
    tp = int(((pred == 1) & (target == 1)).sum())
    fp = int(((pred == 1) & (target == 0)).sum())
    tn = int(((pred == 0) & (target == 0)).sum())
    fn = int(((pred == 0) & (target == 1)).sum())
    return tp, fp, tn, fn


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    order = np.argsort(x)
    return float(np.trapezoid(y[order], x[order]))


def binary_auroc(scores: np.ndarray, target: np.ndarray) -> float:
    """AUROC via the rank statistic (exact, ties averaged)."""
    pos = scores[target == 1]
    neg = scores[target == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    order = np.argsort(np.concatenate([pos, neg]), kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_scores = np.concatenate([pos, neg])[order]
    # average ranks over ties
    ranks[order] = np.arange(1, len(order) + 1)
    uniq, inv, counts = np.unique(
        sorted_scores, return_inverse=True, return_counts=True
    )
    if (counts > 1).any():
        cum = np.cumsum(counts)
        avg = (cum - (counts - 1) / 2.0).astype(np.float64)
        ranks[order] = avg[inv]
    r_pos = ranks[: len(pos)].sum()
    auc = (r_pos - len(pos) * (len(pos) + 1) / 2) / (
        len(pos) * len(neg)
    )
    return float(auc)


def binary_auprc(scores: np.ndarray, target: np.ndarray) -> float:
    """Average precision (area under PR curve, step interpolation)."""
    if target.sum() == 0:
        return float("nan")
    order = np.argsort(-scores, kind="mergesort")
    t = target[order]
    tp = np.cumsum(t)
    precision = tp / np.arange(1, len(t) + 1)
    recall = tp / t.sum()
    # AP = sum over positives of precision at each positive hit
    return float(precision[t == 1].mean())


def binary_metrics(
    logits: np.ndarray, target: np.ndarray, threshold: float = 0.5
) -> Dict[str, float]:
    """Element-wise binary suite over (possibly multi-label) logits."""
    scores = _sigmoid(np.asarray(logits, np.float64)).reshape(-1)
    target = np.asarray(target).reshape(-1).astype(np.int64)
    pred = (scores >= threshold).astype(np.int64)
    tp, fp, tn, fn = _binary_counts(pred, target)
    eps = 1e-12
    return {
        "precision": tp / max(tp + fp, 1),
        "recall": tp / max(tp + fn, 1),
        "accuracy": (tp + tn) / max(len(target), 1),
        "specificity": tn / max(tn + fp, 1),
        "f1": 2 * tp / max(2 * tp + fp + fn, 1),
        "auroc": binary_auroc(scores, target),
        "auprc": binary_auprc(scores, target),
        "cm": np.array([[tn, fp], [fn, tp]], np.int64),
    }


def multiclass_metrics(
    logits: np.ndarray, target: np.ndarray, num_classes: int
) -> Dict[str, float]:
    """Macro-averaged multiclass suite (torchmetrics defaults)."""
    logits = np.asarray(logits, np.float64)
    target = np.asarray(target).reshape(-1).astype(np.int64)
    pred = logits.argmax(axis=-1)
    cm = np.zeros((num_classes, num_classes), np.int64)
    for t, p in zip(target, pred):
        cm[t, p] += 1
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(axis=0) - tp
    fn = cm.sum(axis=1) - tp
    tn = cm.sum() - tp - fp - fn
    prec = tp / np.maximum(tp + fp, 1)
    rec = tp / np.maximum(tp + fn, 1)
    spec = tn / np.maximum(tn + fp, 1)
    f1 = 2 * tp / np.maximum(2 * tp + fp + fn, 1)
    # softmax scores for one-vs-rest AUROC/AUPRC
    z = logits - logits.max(axis=-1, keepdims=True)
    probs = np.exp(z) / np.exp(z).sum(axis=-1, keepdims=True)
    aurocs, auprcs = [], []
    for c in range(num_classes):
        t = (target == c).astype(np.int64)
        if t.sum() == 0 or t.sum() == len(t):
            continue
        aurocs.append(binary_auroc(probs[:, c], t))
        auprcs.append(binary_auprc(probs[:, c], t))
    return {
        "precision": float(prec.mean()),
        "recall": float(rec.mean()),
        "accuracy": float((pred == target).mean()),
        "specificity": float(spec.mean()),
        "f1": float(f1.mean()),
        "auroc": float(np.mean(aurocs)) if aurocs else float("nan"),
        "auprc": float(np.mean(auprcs)) if auprcs else float("nan"),
        "cm": cm,
    }


#: reference-familiar alias (ref utils/metrics.py:82)
get_rank_metrics = rank_metrics


def pearson_r(pred: np.ndarray, target: np.ndarray) -> float:
    pred = np.asarray(pred, np.float64).reshape(-1)
    target = np.asarray(target, np.float64).reshape(-1)
    pc = pred - pred.mean()
    tc = target - target.mean()
    denom = np.sqrt((pc**2).sum() * (tc**2).sum())
    return float((pc * tc).sum() / max(denom, 1e-12))
