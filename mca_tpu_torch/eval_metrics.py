"""Eval-epoch metrics on the eval device, ported from ``mca_tpu/eval_metrics.py``.

The whole epoch's embeddings stay on the device; :func:`epoch_metrics`
reduces them to Wang & Isola uniformity and alignment, each raw and
L2-normalised, and the training loop copies the scalars to the host
once per epoch, not once per batch.

Uniformity is ``log(mean(exp(-t * ||xi - xj||^2)))`` over the distinct
pairs of masked rows, with the squared distances from the Gram
identity (one ``[N, D] x [D, N]`` product); alignment is
``mean(||x - y||^alpha)`` over the masked rows.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def masked_uniformity(
    x: torch.Tensor, mask: torch.Tensor, t: float = 2.0, norm: bool = False
) -> torch.Tensor:
    """``log mean_{i != j, both masked} exp(-t ||xi - xj||^2)``."""
    x = _l2norm(x) if norm else x
    m = mask.to(x.dtype)
    sqn = x.square().sum(-1)
    sq = (sqn[:, None] + sqn[None, :] - 2.0 * (x @ x.T)).clamp_min(0.0)
    w = m[:, None] * m[None, :]
    w = w * (1.0 - torch.eye(x.shape[0], dtype=x.dtype, device=x.device))
    denom = w.sum().clamp_min(1.0)
    return ((w * torch.exp(-t * sq)).sum() / denom).clamp_min(1e-38).log()


def masked_alignment(
    x: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor,
    alpha: float = 2.0,
    norm: bool = False,
) -> torch.Tensor:
    """``mean_{masked} ||xi - yi||^alpha``."""
    x = _l2norm(x) if norm else x
    y = _l2norm(y) if norm else y
    m = mask.to(x.dtype)
    d = (x - y).square().sum(-1).clamp_min(1e-24).sqrt().pow(alpha)
    return (d * m).sum() / m.sum().clamp_min(1.0)


def epoch_metrics(
    emb: Sequence[torch.Tensor],
    msk: Sequence[torch.Tensor],
    *,
    emb_names: Tuple[str, ...],
    mask_names: Tuple[str, ...],
    fusion: bool,
    t: float = 2.0,
    alpha: float = 2.0,
) -> Tuple[Dict, Dict, Dict]:
    """Reduce an eval epoch's stacked outputs, one ``[E, B, D]``
    embedding stack (``emb_names`` order) and one ``[M, B]`` presence
    stack (``mask_names`` order) per batch, to ``(unif, align, counts)``:
    ``{key: {"raw": scalar, "norm": scalar}}`` twice and ``{key:
    rows present}``, all tensors on the device."""
    e = torch.stack(list(emb)).float()  # [T, E, B, D]
    m = torch.stack(list(msk))  # [T, M, B]
    n_batches, n_emb, bsz, dim = e.shape
    by_emb = dict(zip(emb_names, e.transpose(0, 1).reshape(n_emb, n_batches * bsz, dim)))
    by_msk = dict(
        zip(mask_names, m.transpose(0, 1).reshape(len(mask_names), n_batches * bsz).bool())
    )
    ones = torch.ones(n_batches * bsz, dtype=torch.bool, device=e.device)
    unif, align, counts = {}, {}, {}
    for k in list(mask_names) + (["fusion"] if fusion else []):
        mk = ones if k == "fusion" else by_msk[k]
        counts[k] = mk.sum()
        unif[k] = {
            "raw": masked_uniformity(by_emb[k], mk, t, norm=False),
            "norm": masked_uniformity(by_emb[k], mk, t, norm=True),
        }
    if fusion:
        for k in mask_names:
            align[k] = {
                "raw": masked_alignment(by_emb[k], by_emb["fusion"], by_msk[k], alpha, norm=False),
                "norm": masked_alignment(by_emb[k], by_emb["fusion"], by_msk[k], alpha, norm=True),
            }
    return unif, align, counts
