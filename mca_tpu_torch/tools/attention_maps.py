"""Attention maps, ported from ``mca_tpu/tools/attention_maps.py``.

    python -m mca_tpu_torch.tools.attention_maps cfg.yaml
        [--out attention_maps.npz] [--split train|test] [--device cpu]

Runs the first batch of a split through the config's MCA model (the
parameters of ``restart:`` when it is set, random ones from seed 0
otherwise) on the dense attention path and saves the post-softmax
probabilities (fp32) to an ``.npz`` with the JAX tool's keys:

- ``layers``: ``[depth, B, H, T, T]``;
- ``pool``: ``[B, H, R, T]`` (attentive pooling only);
- ``token_types``: ``[T]``, the modality of each packed position (-1 for
  a fusion token).

EAO is refused, as in the JAX tool (its passes run unmasked).  At
TCGA_config1's batch of 8, ``layers`` alone is 5 * 8 * 8 * 2548^2 * 4
bytes = 8.3 GB: pass a small ``batch_size`` to inspect a full-width
model.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)


def extract_attention_maps(config, split: str = "train",
                           rows: Optional[Sequence[Dict[str, Any]]] = None,
                           device: str = "cuda") -> Dict[str, np.ndarray]:
    """The maps of the first batch of ``split`` (module docstring) as
    numpy arrays.  ``rows``: row dicts held in memory in place of
    ``dataset:``, split as the HF split would split them."""
    from mca_tpu_torch import checkpoint
    from mca_tpu_torch.config import get_model_config
    from mca_tpu_torch.data.collators import MultimodalCollator
    from mca_tpu_torch.data.dataset import BatchedLoader, setup_data
    from mca_tpu_torch.data.staging import to_device
    from mca_tpu_torch.models import build_model
    from mca_tpu_torch.train import plain, require_device

    model_config = get_model_config(config)
    if model_config["eao"]:
        raise ValueError("attention maps are an MCA / zorro introspection tool "
                         "(EAO runs unmasked passes)")
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
    with torch.inference_mode():
        maps = model.attention_maps(batch)
    out = {k: v.float().cpu().numpy() for k, v in maps.items()}
    out["token_types"] = np.asarray(model.mask_set.token_types)
    return out


def main(argv=None) -> None:
    from mca_tpu_torch.config import training_config

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("--out", default="attention_maps.npz")
    ap.add_argument("--split", default="train", choices=("train", "test"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    maps = extract_attention_maps(training_config(args.config), split=args.split,
                                  device=args.device)
    np.savez_compressed(args.out, **maps)
    logger.info("wrote %s: %s", os.path.abspath(args.out),
                {k: v.shape for k, v in maps.items()})


if __name__ == "__main__":
    main()
