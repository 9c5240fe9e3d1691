"""Generate the experiment-config corpus from the sweep grammar, ported
from ``mca_tpu/tools/gen_corpus.py`` (framework-free: the port keeps its
own copy, and writes the same files byte for byte).

The reference ships 244 hand-edited YAMLs whose filenames encode a DSL
(SURVEY.md §2.9; examples: ref configs/CMU_config1_d15_z_12i_eval.yaml):

- ``dNN``  — offline whole-modality dropout: ``predrop: true`` +
  ``modality_config[*].dropout = 0.NN`` (ref CMU_config1_d15.yaml diff)
- ``z``    — ``zorro: true`` (MMA masking)
- ``bm``   — bimodal loss: ``bimodal_contrastive + non_fusion_fcl``
  (CMU base sets both False; TCGA base already True)
- ``j``    — zorro + ``mean_pool: true`` + ``fcl: false``
- ``EAO``  — ``eao/no_fusion/mean_pool: true``, ``fcl_root: [0,1]``,
  ``fusion_combos: [2]`` (ref TCGA_config1_EAO.yaml)
- ``NNi``  — inference config: ``restart: <run>/<NN>`` epoch checkpoint
- ``diNN`` — dropout-at-inference on an ``NNi`` config
- ``_eval`` — linear-probe config (``embedding_dir``, task, loss_type)

This module generates the equivalent corpus programmatically — a
systematic grid over the same axes instead of 244 hand-maintained
files.  ``python -m mca_tpu_torch.tools.gen_corpus --out corpus``; every
file loads through :func:`mca_tpu_torch.config.training_config` (train
and inference configs) or :func:`~mca_tpu_torch.config.embedding_eval_config`
(``_eval`` configs).  The default ``--out`` is ``corpus`` in the working
directory: the committed ``configs/corpus/`` is the JAX package's.
"""

from __future__ import annotations

import argparse
import copy
import os
from typing import Any, Dict, List, Tuple

import yaml

# ---------------------------------------------------------------------------
# Canonical bases (ref configs/TCGA_config1.yaml, CMU_config1.yaml)
# ---------------------------------------------------------------------------

TCGA_BASE: Dict[str, Any] = {
    "encoder_configs": {
        "gene": {"type": "TabularEncoder", "num_embeddings": 800,
                 "max_tokens": 800, "max_value": 100},
        "protein": {"type": "TabularEncoder", "num_embeddings": 198,
                    "max_tokens": 198, "max_value": 100},
        "methylation": {"type": "TabularEncoder", "num_embeddings": 800,
                        "max_tokens": 800, "max_value": 100},
        "mirna": {"type": "TabularEncoder", "num_embeddings": 662,
                  "max_tokens": 662, "max_value": 100},
    },
    "modality_config": {
        m: {"type": "sequence", "pad_len": w, "data_col_name": "values",
            "pad_token": -10000}
        for m, w in (("gene", 800), ("protein", 198),
                     ("methylation", 800), ("mirna", 662))
    },
    "num_fusion_tokens": 88,
    "ds_frac": 1.0,
    "predrop": False,
    "batch_size": 8,
    "ds_seed": 43,
    "seed": 43,
    "lr": 1.0e-4,
    "layers": 5,
    "lr_scheduler_type": "cosine",
    "epochs": 128,
    "bimodal_contrastive": True,
    "non_fusion_fcl": True,
    "fcl": True,
    "fcl_root": [0, 1, 2, 3],
    "fusion_combos": [4, 3, 2],
    "zorro": False,
    "clip": 2.0,
    "dataset": "data/tcga_dataset",
}

CMU_BASE: Dict[str, Any] = {
    "encoder_configs": {
        "COVAREP": {"type": "EmbeddedSequenceEncoder", "input_size": 74,
                    "max_tokens": 1500},
        "FACET": {"type": "EmbeddedSequenceEncoder", "input_size": 35,
                  "max_tokens": 450},
        "OpenFace": {"type": "EmbeddedSequenceEncoder", "input_size": 713,
                     "max_tokens": 450},
        "glove_vectors": {"type": "EmbeddedSequenceEncoder",
                          "input_size": 300, "max_tokens": 50},
    },
    "modality_config": {
        m: {"type": "embedded_sequence", "pad_len": t,
            "data_col_name": "data", "pad_token": -10000,
            "embedding_size": d}
        for m, (d, t) in (("COVAREP", (74, 1500)), ("FACET", (35, 450)),
                          ("OpenFace", (713, 450)),
                          ("glove_vectors", (300, 50)))
    },
    "num_fusion_tokens": 88,
    "ds_frac": 1.0,
    "predrop": False,
    "batch_size": 8,
    "ds_seed": 43,
    "seed": 43,
    "lr": 1.0e-4,
    "layers": 5,
    "lr_scheduler_type": "cosine",
    "epochs": 32,
    "bimodal_contrastive": False,
    "non_fusion_fcl": False,
    "fcl": True,
    "fcl_root": [0, 1, 2, 3],
    "fusion_combos": [4, 3, 2],
    "zorro": False,
    "clip": 2.0,
    "dataset": "data/cmu_dataset",
}

# probe tasks per dataset (ref TCGA_60i_eval.yaml; CMU_config1_12i_eval.yaml
# = task 2 BCE mlp; CMU sentiment probes use task 0 L1 linear)
TCGA_EVAL = {"model_type": "linear", "epochs": 10001, "loss_type": "BCE",
             "metric": "F1", "task": -1, "lr": 1.0e-4, "rank_metrics": True}
CMU_EVAL_SENT = {"model_type": "linear", "epochs": 5120, "loss_type": "L1",
                 "metric": "PCC", "task": 0, "rank_metrics": True}
CMU_EVAL_EMO = {"model_type": "mlp", "epochs": 5120, "loss_type": "BCE",
                "metric": "F1", "task": 2, "rank_metrics": True}


# ---------------------------------------------------------------------------
# DSL transforms
# ---------------------------------------------------------------------------


def apply_d(cfg: Dict[str, Any], nn: int) -> None:
    cfg["predrop"] = True
    for mod in cfg["modality_config"].values():
        mod["dropout"] = nn / 100.0


def apply_z(cfg: Dict[str, Any]) -> None:
    cfg["zorro"] = True


def apply_bm(cfg: Dict[str, Any]) -> None:
    cfg["bimodal_contrastive"] = True
    cfg["non_fusion_fcl"] = True


def apply_j(cfg: Dict[str, Any]) -> None:
    cfg["zorro"] = True
    cfg["mean_pool"] = True
    cfg["fcl"] = False


def apply_eao(cfg: Dict[str, Any]) -> None:
    cfg["eao"] = True
    cfg["no_fusion"] = True
    cfg["mean_pool"] = True
    cfg["fcl_root"] = [0, 1]
    cfg["fusion_combos"] = [2]


MODEL_TRANSFORMS = {
    "": lambda c: None,
    "z": apply_z,
    "j": apply_j,
    "EAO": apply_eao,
}


def make_infer(cfg: Dict[str, Any], run_name: str, epoch: int,
               runs_dir: str, di: int | None = None) -> Dict[str, Any]:
    """``NNi`` (+optional ``diNN``) transform (ref CMU_config1_12i.yaml
    diff: restart at the epoch checkpoint, pinned output_dir)."""
    icfg = copy.deepcopy(cfg)
    icfg["restart"] = f"{runs_dir}/{run_name}/{epoch}"
    icfg["output_dir"] = f"{runs_dir}/{run_name}_{epoch}i" + (
        f"_di{di}" if di is not None else ""
    )
    if di is not None:
        icfg["predrop"] = True
        for mod in icfg["modality_config"].values():
            mod["dropout"] = di / 100.0
    return icfg


def make_eval(infer_name: str, runs_dir: str,
              spec: Dict[str, Any]) -> Dict[str, Any]:
    ecfg = dict(spec)
    ecfg["embedding_dir"] = f"{runs_dir}/{infer_name}"
    return ecfg


# ---------------------------------------------------------------------------
# Grid
# ---------------------------------------------------------------------------


def generate(runs_dir: str = "runs") -> List[Tuple[str, Dict[str, Any]]]:
    """(name, config) pairs for the full sweep corpus."""
    out: List[Tuple[str, Dict[str, Any]]] = []

    def emit_family(dataset: str, base: Dict[str, Any], models: List[str],
                    drops: List[int | None], infer_epochs: Dict[str, List[int]],
                    eval_specs: List[Tuple[str, Dict[str, Any]]],
                    di_grid: List[int], bm_models: List[str]):
        for model in models:
            bm_opts = [False, True] if model in bm_models else [False]
            for bm in bm_opts:
                for d in drops:
                    name = f"{dataset}_config1"
                    if model:
                        name += f"_{model}"
                    if d:
                        name += f"_d{d}"
                    if bm:
                        name += "_bm"
                    cfg = copy.deepcopy(base)
                    cfg["output_dir"] = f"{runs_dir}/{name}"
                    MODEL_TRANSFORMS[model](cfg)
                    if d:
                        apply_d(cfg, d)
                    if bm:
                        apply_bm(cfg)
                    out.append((name, cfg))
                    for epoch in infer_epochs.get(model, infer_epochs[""]):
                        icfg = make_infer(cfg, name, epoch, runs_dir)
                        iname = f"{name}_{epoch}i"
                        out.append((iname, icfg))
                        for suffix, spec in eval_specs:
                            out.append(
                                (f"{iname}{suffix}_eval",
                                 make_eval(iname, runs_dir, spec))
                            )
                        # dropout-at-inference variants on the first
                        # epoch point only (matches the reference's
                        # sparse diNN coverage)
                        if d and epoch == infer_epochs.get(
                            model, infer_epochs[""]
                        )[0]:
                            for di in di_grid:
                                dicfg = make_infer(
                                    cfg, name, epoch, runs_dir, di=di
                                )
                                diname = f"{name}_{epoch}i_di{di}"
                                out.append((diname, dicfg))
                                for suffix, spec in eval_specs:
                                    out.append(
                                        (f"{diname}{suffix}_eval",
                                         make_eval(diname, runs_dir, spec))
                                    )

    emit_family(
        "TCGA", TCGA_BASE,
        models=["", "z", "EAO"],
        drops=[None, 20, 40, 60, 80],
        infer_epochs={"": [60, 80], "z": [60, 80], "EAO": [45]},
        eval_specs=[("", TCGA_EVAL)],
        di_grid=[60],
        bm_models=[],
    )
    emit_family(
        "CMU", CMU_BASE,
        models=["", "z", "j", "EAO"],
        drops=[None, 15, 30, 60, 80],
        infer_epochs={"": [4, 12, 30], "z": [4, 12, 30],
                      "j": [4, 12, 30], "EAO": [12]},
        eval_specs=[("_sent", CMU_EVAL_SENT), ("_emo", CMU_EVAL_EMO)],
        di_grid=[0, 60],
        bm_models=["", "z"],
    )
    return out


def write_corpus(out_dir: str, runs_dir: str = "runs") -> int:
    os.makedirs(out_dir, exist_ok=True)
    corpus = generate(runs_dir)
    for name, cfg in corpus:
        with open(os.path.join(out_dir, f"{name}.yaml"), "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
    return len(corpus)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="corpus")
    ap.add_argument("--runs-dir", default="runs")
    args = ap.parse_args(argv)
    n = write_corpus(args.out, args.runs_dir)
    print(f"wrote {n} configs to {args.out}")


if __name__ == "__main__":
    main()
