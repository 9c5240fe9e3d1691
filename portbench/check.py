"""The numbers that decide ``correct``: the program's readings against
the reference's.

Training (three steps followed by both sides from the same weights and
rows):

- ``loss_gap``: the relative gap of the first step's total loss (the
  later steps' gaps are printed beside it: the two sides' rounding
  differs, so their parameters part over the steps, and on a few seeds
  the third step's loss parts by some hundredths while each step, taken
  from the program's own parameters, is the reference's to rounding;
  ``portbench/tools/round_off.py --look`` reads both);
- ``grad_gap``: the first step's clipped gradient, by leaf, as the
  optimizer holds it: the worst gap between the two sides' norms of a
  leaf, over the larger of the reference's norm of that leaf and of the
  median leaf;
- ``update_gap``: the same for each leaf's change over the three steps,
  over the leaves whose reference gradient is at least a thousandth of
  the median leaf's (below that, AdamW moves a leaf by the sign of
  round-off).

Serving (a sample of the requests the window answered):

- ``emb_gap``: the worst relative distance of an answered embedding to
  the reference's, over every key and sampled row;
- ``mask_errors``: presence flags that differ (limit 0).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import numpy as np

SMALL_GRAD = 1e-3


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves) -> Dict[str, float]:
    """``|prog - ref| / max(ref, median ref)`` of each of ``leaves``."""
    med = statistics.median(ref[k] for k in leaves)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves) -> float:
    return max(leaf_gaps(prog, ref, leaves).values())


def worst_leaves(prog: dict, ref: dict) -> str:
    """The leaf that sets ``grad_gap`` and the one that sets ``update_gap``."""
    g = leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"]))
    still = set(still_leaves(ref))
    u = leaf_gaps(prog["change"], ref["change"], [k for k in sorted(ref["grad"]) if k not in still])
    return f"grad_gap at {max(g, key=g.get)}, update_gap at {max(u, key=u.get)}"


def loss_gaps(prog: dict, ref: dict) -> List[float]:
    """Each followed step's relative gap of the total loss."""
    return [abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"])]


def still_leaves(ref: dict) -> List[str]:
    """Leaves whose reference gradient is under ``SMALL_GRAD`` of the
    median leaf's."""
    med = statistics.median(ref["grad"].values())
    return sorted(k for k, g in ref["grad"].items() if g < SMALL_GRAD * med)


def train_numbers(prog: dict, ref: dict) -> List[Tuple[str, float]]:
    loss = loss_gaps(prog, ref)[0]
    leaves = sorted(ref["grad"])
    grad = leaf_gap(prog["grad"], ref["grad"], leaves)
    still = set(still_leaves(ref))
    update = leaf_gap(prog["change"], ref["change"], [k for k in leaves if k not in still])
    return [("loss_gap", loss), ("grad_gap", grad), ("update_gap", update)]


def serve_numbers(answers: List[dict], ref_emb: Dict[str, np.ndarray],
                  ref_present: Dict[str, np.ndarray]) -> List[Tuple[str, float]]:
    """``answers[i]`` is the service's answer for row ``i`` of the
    reference's arrays."""
    worst = 0.0
    errors = 0
    for i, ans in enumerate(answers):
        for k, e in ref_emb.items():
            got = np.asarray(ans["embeddings"][k], np.float64)
            want = e[i].astype(np.float64)
            worst = max(worst, float(np.linalg.norm(got - want) / np.linalg.norm(want)))
        errors += sum(bool(ans["present"][m]) != bool(p[i]) for m, p in ref_present.items())
    return [("emb_gap", worst), ("mask_errors", float(errors))]


def with_limits(numbers: List[Tuple[str, float]], limits: Dict[str, float]):
    return [(n, v, limits.get(n)) for n, v in numbers]
