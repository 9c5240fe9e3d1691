"""Synthetic request rows for driving the service (smoke runs, profiling)."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np


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
