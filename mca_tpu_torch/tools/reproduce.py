"""One-command reproduction, ported from ``mca_tpu/tools/reproduce.py``.

    python -m mca_tpu_torch.tools.reproduce pipeline.yaml [--device cpu]

Chains the reference's four stages, preprocess -> pretrain -> batch
inference -> probe, from one pipeline YAML of the JAX tool's schema
(``configs/reproduce_tcga.yaml``)::

    preprocess:                  # optional; ONE source
      synthetic: {kind: tcga | cmu, n_samples: ..., ...}  # the generator's kwargs
      # tcga: {gene_path: ..., mirna_path: ..., methylation_path: ...,
      #        rppa_path: ..., cdr_path: ...}   # the raw TCGA tables
      # cmu: {data_dir: ...}                    # the CMU-MOSEI .csd directory
      out: ./dataset               # the HF dataset directory to write
    train: {...} or a config path  # merged over the defaults; dataset:
                                   # defaults to preprocess.out
    infer_epoch: -1                # the epoch checkpoint to infer (-1: last)
    probe: {...}                   # probe keys (embedding_dir and
                                   # output_dir are filled in)

Each stage runs through the port: the preprocessors
(:mod:`mca_tpu_torch.data`), :func:`mca_tpu_torch.train.train`,
:func:`mca_tpu_torch.infer.infer` and :func:`mca_tpu_torch.probe.probe`,
on ``device`` (the card unless the CPU is asked for).  The preprocessors
need ``datasets`` (and ``pandas`` / ``h5py`` for the real sources); on a
host without them, :func:`reproduce` takes the rows in memory
(``rows=``, in place of the preprocess stage and of ``dataset:``).

Prints one JSON summary ``{dataset, train_output, inference, probe}`` and
returns it from :func:`reproduce`.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import sys
from typing import Any, Dict, Optional, Sequence

logger = logging.getLogger(__name__)


def _load_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)


def run_preprocess(spec: Dict[str, Any]) -> str:
    """The preprocess stage: ``spec["out"]`` (reused when it exists)."""
    out = spec["out"]
    if os.path.isdir(out) and os.listdir(out):
        logger.info("preprocess: %s already exists, reusing", out)
        return out
    if "synthetic" in spec:
        from mca_tpu_torch.data.synthetic import make_cmu_like, make_tcga_like, to_hf_dataset

        s = dict(spec["synthetic"])
        maker = make_tcga_like if s.pop("kind", "tcga") == "tcga" else make_cmu_like
        to_hf_dataset(maker(**s)).save_to_disk(out)
    elif "tcga" in spec:
        from mca_tpu_torch.data.preprocess_tcga import process

        process(out_path=out, **spec["tcga"])
    elif "cmu" in spec:
        from mca_tpu_torch.data.preprocess_cmu import process

        process(out_path=out, **spec["cmu"])
    else:
        raise ValueError("preprocess needs one of: synthetic / tcga / cmu")
    logger.info("preprocess: wrote %s", out)
    return out


def reproduce(pipeline: Dict[str, Any], device: str = "cuda",
              rows: Optional[Sequence[Dict[str, Any]]] = None) -> Dict[str, Any]:
    """Run the pipeline (module docstring); returns its summary.
    ``rows``: row dicts held in memory, in place of the preprocess stage
    and of the train config's ``dataset:``."""
    from mca_tpu_torch.config import (_auto_output_dir, dump_configs,
                                      get_cfg_defaults_embedding_eval, training_config,
                                      training_config_from_dict)
    from mca_tpu_torch.infer import infer
    from mca_tpu_torch.probe import probe
    from mca_tpu_torch.train import train

    summary: Dict[str, Any] = {}
    dataset = None
    if rows is not None:
        summary["dataset"] = f"{len(rows)} rows in memory"
    elif pipeline.get("preprocess"):
        dataset = summary["dataset"] = run_preprocess(pipeline["preprocess"])

    tspec = pipeline.get("train") or {}  # a bare `train:` takes every default
    if isinstance(tspec, str):
        cfg = training_config(tspec, make_output_dir=True)
    else:
        cfg = training_config_from_dict(dict(tspec))
        if not cfg.output_dir:
            cfg.output_dir = _auto_output_dir()
        dump_configs(cfg, cfg.output_dir)
    # preprocess.out is a default for dataset:, never an override
    if dataset and not cfg.dataset:
        cfg.dataset = dataset
    train_out = summary["train_output"] = train(cfg, device, rows=rows)

    epoch = int(pipeline.get("infer_epoch", -1))
    if epoch < 0:
        epoch = int(cfg.epochs) - 1
    icfg = copy.deepcopy(cfg)
    icfg.restart = os.path.join(train_out, str(epoch))
    icfg.output_dir = os.path.join(train_out, "inference")
    os.makedirs(icfg.output_dir, exist_ok=True)
    infer(icfg, device, rows=rows)
    summary["inference"] = icfg.output_dir

    ecfg = get_cfg_defaults_embedding_eval()
    ecfg.merge(dict(pipeline.get("probe") or {}))
    ecfg.embedding_dir = icfg.output_dir
    if not ecfg.output_dir:
        ecfg.output_dir = os.path.join(train_out, "probe")
    os.makedirs(ecfg.output_dir, exist_ok=True)
    metrics = probe(ecfg, device)
    summary["probe"] = {k: float(v) for k, v in metrics.items()
                        if isinstance(v, (int, float)) or hasattr(v, "item")}
    return summary


def main(argv=None) -> None:
    import argparse

    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pipeline", help="the pipeline YAML")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    summary = reproduce(_load_yaml(args.pipeline), device=args.device)
    print(json.dumps(summary, indent=2, default=str))


if __name__ == "__main__":
    main()
