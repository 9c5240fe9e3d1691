"""Synthetic rows for driving the port (smoke runs, profiling, training).

- :func:`tabular_rows` — request rows for the embedding service.
- :func:`make_tcga_like` — the port's copy of
  ``mca_tpu.data.synthetic.make_tcga_like``: TCGA-shaped training rows
  with a shared planted latent, numpy-seeded, so the same seed gives the
  same rows as the JAX package's generator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

TCGA_MODALITIES = {
    "gene": 800,
    "protein": 198,
    "methylation": 800,
    "mirna": 662,
}


def tabular_rows(
    modality_config: Dict[str, Dict[str, Any]], n: int, seed: int = 1
) -> List[Dict[str, Any]]:
    """``n`` rows of standard-normal tabular values, one ``values`` field
    per ``sequence`` modality; every fifth row has a ragged tail padded
    with the modality's pad token, and every seventh misses one
    modality entirely (all pad tokens)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        row = {}
        for j, (m, c) in enumerate(modality_config.items()):
            w = int(c["pad_len"])
            pad = float(c.get("pad_token", -10000.0))
            vals = rng.normal(size=w).astype(np.float32)
            if i % 5 == 2:
                vals[int(rng.integers(w // 2, w)) :] = pad
            if i % 7 == 3 and j == i % len(modality_config):
                vals[:] = pad
            row[m] = {"values": vals}
        rows.append(row)
    return rows


def make_tcga_like(
    n_samples: int = 64,
    widths: Optional[Dict[str, int]] = None,
    n_classes: int = 5,
    latent_dim: int = 8,
    p_missing: float = 0.0,
    pad_token: float = -10000.0,
    seed: int = 0,
    clustered: bool = False,
) -> List[Dict[str, Any]]:
    """List of sample dicts ``{modality: {'values': [W]}, 'Labels':
    {'values': one-hot}}``: every modality observes a per-sample latent
    through its own random linear map (plus noise), so contrastive
    alignment is learnable; with probability ``p_missing`` a modality is
    all ``pad_token`` (missing).  ``clustered=True`` draws the latent
    from per-class Gaussian clusters instead of labelling a continuous
    latent by argmax."""
    rng = np.random.default_rng(seed)
    widths = widths or TCGA_MODALITIES
    maps = {
        m: rng.normal(size=(latent_dim, w)).astype(np.float32)
        for m, w in widths.items()
    }
    class_w = rng.normal(size=(latent_dim, n_classes)).astype(np.float32)
    centers = 2.0 * rng.normal(size=(n_classes, latent_dim)).astype(np.float32)
    samples = []
    for _ in range(n_samples):
        if clustered:
            cls = int(rng.integers(n_classes))
            z = centers[cls] + 0.5 * rng.normal(size=(latent_dim,)).astype(
                np.float32
            )
        else:
            z = rng.normal(size=(latent_dim,)).astype(np.float32)
        sample: Dict[str, Any] = {}
        for m, w in widths.items():
            if rng.random() < p_missing:
                vals = np.full((w,), pad_token, dtype=np.float32)
            else:
                vals = z @ maps[m] + 0.1 * rng.normal(size=(w,)).astype(
                    np.float32
                )
            sample[m] = {"values": vals}
        label = np.zeros((n_classes,), dtype=np.float32)
        label[cls if clustered else int(np.argmax(z @ class_w))] = 1.0
        sample["Labels"] = {"values": label}
        samples.append(sample)
    return samples
