"""Batch embedding inference on the GPU, ported from ``mca_tpu/infer.py``.

    python -m mca_tpu_torch.infer cfg.yaml [--device cpu] [--synthetic N]

:func:`infer` reads the parameters of ``config.restart`` (a train-state
directory or a final-model directory, :func:`checkpoint.load_params`),
runs the model over the train and test splits of ``dataset:`` in order
(``shuffle=False``, ``drop_last=True``) and writes, per split,
``{train,eval}_{embeddings,masks,labels}.pt`` into ``output_dir`` in
the JAX package's (and the reference's) format: ``torch.save`` of
``{key: tensor}``, keyed by modality name (str), modality combo
(``frozenset`` of modality indices) and ``'fusion'``; masks by modality
name; the labels as one bare tensor (TCGA's one-hot classes under
``values``; CMU-MOSEI's 7 floats, sentiment then six emotions, under
``data``).  ``--synthetic N`` reads N rows made from the config's seed
(TCGA- or CMU-shaped, as the config's modalities are) instead of
``dataset:``.

The model is the MCA or EAO family of the config with the fused
feed-forward (the forward-only process, as ``mca_tpu.infer.main`` sets
``MCA_FUSED_FF=auto``): on the card every block runs the flash forward
(K1) and the fused GEGLU (K5; a ``moe_experts`` block runs its experts
as plain products instead).  The loss graph stays on, so that each
split's mean loss is logged.  Each batch's outputs stay on the device;
each split ends in one copy to the host.

``steps_per_call`` batches K forwards into one ``lax.scan`` launch in
the JAX package and changes no result; eager PyTorch has no such
launch, so the key is accepted and has no effect here.  The multi-host
gather comes with the parallelism slice: ``mesh_data > 1`` or
``mesh_model > 1`` raises before anything is read.  The entry point runs on
``cuda`` and raises without one; pass ``--device cpu`` for the plain
versions of the kernels.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mca_tpu_torch import checkpoint
from mca_tpu_torch.config import get_model_config
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.dataset import BatchedLoader, setup_data
from mca_tpu_torch.models import build_model
from mca_tpu_torch.train import (check_mesh_keys, plain, require_device, synthetic_rows,
                                 to_device)

logger = logging.getLogger(__name__)

#: output keys that are not embeddings
NON_EMBEDDING_KEYS = ("loss", "losses", "fcl_loss", "no-fcl_loss", "modality_sample_mask")


def combo_str_to_frozenset(key: str) -> frozenset:
    """``"combo:0,2"`` -> ``frozenset({0, 2})``."""
    return frozenset(int(i) for i in key.split(":", 1)[1].split(","))


def _save(obj: Mapping[Any, np.ndarray], path_stem: str) -> None:
    """``torch.save`` of ``{key: tensor}`` to ``path_stem.pt``."""
    torch.save(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in obj.items()},
        path_stem + ".pt",
    )


def _save_array(arr: np.ndarray, path_stem: str) -> None:
    """One bare tensor to ``path_stem.pt`` (the reference stores the
    labels so)."""
    torch.save(torch.from_numpy(np.ascontiguousarray(arr)), path_stem + ".pt")


def _load_pt(path: str) -> Any:
    # the embedding files key combos by frozenset, which the
    # weights-only unpickler takes once allowed
    with torch.serialization.safe_globals([frozenset]):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_label_file(path_stem: str) -> np.ndarray:
    """The labels of ``path_stem.pt`` or, failing that, ``path_stem.npz``
    (the JAX package's file without torch)."""
    if os.path.exists(path_stem + ".pt"):
        return _load_pt(path_stem + ".pt").numpy()
    return np.load(path_stem + ".npz", allow_pickle=True)["labels"]


def load_embedding_file(path_stem: str) -> Dict[Any, np.ndarray]:
    """Embeddings or masks written by :func:`infer`, by ``mca_tpu.infer``
    or by the reference (``.pt``), or the JAX package's ``.npz``."""
    if os.path.exists(path_stem + ".pt"):
        return {k: v.numpy() for k, v in _load_pt(path_stem + ".pt").items()}
    data = np.load(path_stem + ".npz", allow_pickle=True)
    return {k: data[k] for k in data.files}


def split_output_keys(out: Mapping[str, Any]) -> Tuple[List[str], List[str]]:
    """``(embedding keys, mask keys)`` of a model output, each sorted."""
    emb_keys = sorted(k for k in out if k not in NON_EMBEDDING_KEYS)
    return emb_keys, sorted(out["modality_sample_mask"])


def build_inference_model(config, device: str = "cuda"):
    """The config's model with the fused feed-forward and the parameters
    of ``config.restart``, in ``eval()`` on ``device``."""
    if not config.restart:
        raise ValueError("inference needs restart: a checkpoint or model directory")
    dev = require_device(device)
    model = build_model(get_model_config(config), fused_ff=True)
    model.load_state_dict(checkpoint.load_params(config.restart), strict=True)
    return model.to(dev).eval()


def infer_split(model, loader, label_col: str,
                device) -> Tuple[Dict, Dict, np.ndarray, List[float]]:
    """One split through ``model``: ``(embeddings, masks, labels, per-batch
    losses)`` on the host, keyed as the files are."""
    emb_keys = mask_keys = label_field = None
    packed, labels, bsz, dim = [], [], 0, 0
    with torch.inference_mode():
        for batch in loader:
            batch_labels = batch.pop(label_col)
            # the reference reads batch['Labels']['data']; TCGA-style
            # datasets store them under 'values'
            label_field = label_field or next(
                (f for f in ("data", "values") if f in batch_labels),
                next(iter(batch_labels)),
            )
            labels.append(np.asarray(batch_labels[label_field]))
            out = model(to_device(batch, device), no_loss=False)
            if emb_keys is None:
                emb_keys, mask_keys = split_output_keys(out)
                bsz, dim = out[emb_keys[0]].shape
            packed.append(torch.cat([
                torch.stack([out[k].float() for k in emb_keys]).reshape(-1),
                torch.stack([out["modality_sample_mask"][k] for k in mask_keys])
                .float().reshape(-1),
                out["loss"].float().reshape(1),
            ]))
        if not packed:
            raise ValueError("the split holds fewer rows than one batch")
        host = torch.stack(packed).cpu().numpy()  # the split's one copy
    n, cut = len(host), len(emb_keys) * bsz * dim
    emb = host[:, :cut].reshape(n, len(emb_keys), bsz, dim)
    msk = host[:, cut:-1].reshape(n, len(mask_keys), bsz)
    embeddings = {
        combo_str_to_frozenset(k) if k.startswith("combo:") else k:
            np.concatenate(emb[:, j]) for j, k in enumerate(emb_keys)
    }
    masks = {k: np.concatenate(msk[:, j]).astype(bool) for j, k in enumerate(mask_keys)}
    return embeddings, masks, np.concatenate(labels), host[:, -1].tolist()


def infer(config, device: str = "cuda", rows: Optional[Sequence[Dict[str, Any]]] = None) -> str:
    """Write the six embedding files into ``config.output_dir`` (module
    docstring); returns ``output_dir``.  ``rows``: row dicts held in
    memory in place of ``dataset:``, split as the HF split would split
    them."""
    check_mesh_keys(config)
    if not config.output_dir:
        raise ValueError("output_dir is empty: set it, or load the config with "
                         "training_config(..., make_output_dir=True)")
    if rows is None and not config.dataset:
        raise ValueError("no data: set dataset: to a save_to_disk directory, or pass rows")
    model = build_inference_model(config, device)
    dev = next(model.parameters()).device
    os.makedirs(config.output_dir, exist_ok=True)
    mc = plain(config.modality_config)
    data = setup_data(
        config.dataset if rows is None else rows,
        split=config.split, ds_frac=config.ds_frac, ds_seed=config.ds_seed,
        predrop=config.predrop, predrop_config=mc,
    )
    collator = MultimodalCollator(mc, labels=config.label_col)
    preload = bool(config.get("preload_dataset", True))
    prefetch = int(config.get("prefetch_batches", 0))
    for split, part in (("train", data["train"]), ("eval", data["test"])):
        loader = BatchedLoader(part, collator, int(config.batch_size),
                               preload=preload, prefetch=prefetch)
        embeddings, masks, labels, losses = infer_split(model, loader, config.label_col, dev)
        logger.info("%s split: %d batches, mean loss %.4f", split, len(losses),
                    float(np.mean(losses)))
        stem = os.path.join(config.output_dir, split)
        _save(masks, f"{stem}_masks")
        _save(embeddings, f"{stem}_embeddings")
        _save_array(labels, f"{stem}_labels")
    return config.output_dir


def main(argv=None) -> None:
    from mca_tpu_torch.config import training_config

    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("config", help="train yaml with restart: set")
    p.add_argument("--synthetic", type=int, default=0,
                   help="read N synthetic rows (TCGA- or CMU-shaped, as the "
                        "config's modalities are) made from the config's seed "
                        "instead of dataset:")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    config = training_config(args.config, make_output_dir=True)
    rows = synthetic_rows(config, args.synthetic, seed=int(config.seed)) if args.synthetic else None
    infer(config, device=args.device, rows=rows)


if __name__ == "__main__":
    main()
