"""MoE routing statistics, ported from ``mca_tpu/tools/moe_stats.py``.

    python -m mca_tpu_torch.tools.moe_stats cfg.yaml [--out moe_stats.json]
        [--split train|test] [--device cpu]

Expert-choice routing (:mod:`mca_tpu_torch.models.moe`) gives every
expert exactly ``C`` tokens, so what is worth reading is the token side:
the share of real tokens that at least one expert picks (a token no
expert picks gets no FF output; the residual carries it), how many
experts pick a real token on average, the mean gate, and the router
probability mass each expert draws.  They guide the choice of
``moe_capacity_factor``: coverage near 1 means few tokens are dropped;
many experts a token means ``cf`` could come down.

:func:`extract_moe_stats` runs the first batch of a split through the
config's model, with the parameters of ``restart:`` when it is set and
random ones from seed 0 otherwise, and reads each MoE layer's
``record`` hook (set only here, off the training and serving paths):
one row a layer for MCA, one a layer and pass (``call``) for EAO.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def routing_stats(scores: np.ndarray, token_idx: np.ndarray, gates: np.ndarray) -> Dict[str, Any]:
    """Token-side statistics of one MoE call: ``scores`` ``[B, T, E]``
    (a padded token's row is all zero), ``token_idx`` and ``gates``
    ``[B, E, C]``."""
    B, T, E = scores.shape
    C = token_idx.shape[-1]
    real = scores.sum(-1) > 0  # [B, T]; padded rows were zeroed
    n_real = int(real.sum())
    picks = np.zeros((B, T), np.int32)  # experts that picked each token
    np.add.at(picks, (np.arange(B)[:, None, None], token_idx), 1)
    covered = (picks > 0) & real
    per_expert_mass = scores[real].mean(0) if n_real else np.zeros(E)
    return {
        "experts": int(E),
        "capacity": int(C),
        "tokens_real": n_real,
        "tokens_total": int(B * T),
        "coverage_real": float(covered.sum() / max(n_real, 1)),
        "experts_per_real_token": float(picks[real].mean() if n_real else 0.0),
        "mean_gate": float(gates.mean()),
        # balanced routing puts each entry near 1 / E
        "expert_prob_mass": [round(float(v), 6) for v in per_expert_mass],
    }


def extract_moe_stats(config, split: str = "train",
                      rows: Optional[Sequence[Dict[str, Any]]] = None,
                      device: str = "cuda") -> List[Dict[str, Any]]:
    """:func:`routing_stats` of every MoE call in one forward of the
    first batch of ``split`` (module docstring).  ``rows``: row dicts
    held in memory in place of ``dataset:``, split as the HF split would
    split them."""
    from mca_tpu_torch import checkpoint
    from mca_tpu_torch.config import get_model_config
    from mca_tpu_torch.data.collators import MultimodalCollator
    from mca_tpu_torch.data.dataset import BatchedLoader, setup_data
    from mca_tpu_torch.data.staging import to_device
    from mca_tpu_torch.models import build_model
    from mca_tpu_torch.train import plain, require_device

    model_config = get_model_config(config)
    if int(model_config.get("moe_experts", 0) or 0) <= 0:
        raise ValueError("moe_stats needs a config with moe_experts > 0")
    dev = require_device(device)
    model = build_model(model_config, fused_ff=True)
    if config.restart:
        logger.info("loading parameters from %s", config.restart)
        model.load_state_dict(checkpoint.load_params(config.restart), strict=True)
    else:
        model.init_weights(torch.Generator().manual_seed(0))
    model.to(dev).eval()
    mc = plain(config.modality_config)
    data = setup_data(
        config.dataset if rows is None else rows,
        split=config.split, ds_frac=config.ds_frac, ds_seed=config.ds_seed,
        predrop=config.predrop, predrop_config=mc,
    )
    loader = BatchedLoader(data["train" if split == "train" else "test"],
                           MultimodalCollator(mc), int(config.batch_size))
    batch = to_device(loader.first_batch(), dev)
    records = [[] for _ in model.layers]
    try:
        for layer, rec in zip(model.layers, records):
            layer.ff.record = rec
        with torch.inference_mode():
            model(batch, no_loss=True)
    finally:
        for layer in model.layers:
            layer.ff.record = None

    out: List[Dict[str, Any]] = []
    for i, calls in enumerate(records):
        for c, call in enumerate(calls):
            row = routing_stats(*(call[k].cpu().numpy()
                                  for k in ("router_scores", "token_idx", "gates")))
            row["layer"] = f"layer_{i}"
            if len(calls) > 1:
                row["call"] = c
            out.append(row)
    return out


def main(argv=None) -> None:
    from mca_tpu_torch.config import training_config

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config", help="train yaml with moe_experts > 0")
    ap.add_argument("--out", default="moe_stats.json")
    ap.add_argument("--split", default="train", choices=("train", "test"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    rows = extract_moe_stats(training_config(args.config), split=args.split,
                             device=args.device)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    for r in rows:
        logger.info("%s%s: coverage %.3f, experts/token %.2f, mean gate %.3f",
                    r["layer"], f" call {r['call']}" if "call" in r else "",
                    r["coverage_real"], r["experts_per_real_token"], r["mean_gate"])
    logger.info("wrote %s (%d rows)", os.path.abspath(args.out), len(rows))


if __name__ == "__main__":
    main()
