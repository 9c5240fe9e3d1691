"""The paper's experiment grid, end to end, ported from ``mca_tpu/tools/sweep.py``:
``python -m mca_tpu_torch.tools.sweep --out <dir> [--device cpu]``.

The reference exists to run comparative sweeps — configs chaining
pretrain -> ``_Ni`` restart inference -> ``diNN`` inference-dropout ->
``_eval`` probe (ref README.md:19-42; file-naming DSL per SURVEY
§2.11).  This tool executes a miniature version of that grid on
clustered-synthetic TCGA:

    {MCA, zorro (MMA), EAO}  x  predrop {0, 0.15, 0.40}
    + one ``di60`` inference-dropout cell (MCA d15 checkpoint
      inferred under 0.60 modality dropout, ref ``*_di60`` configs)

Every stage goes through the SAME artifacts a reference user would
touch: the tool writes real YAML config files (train configs in the
reference's key surface including its dead keys, ``_Ni``-style
inference configs carrying ``restart: <train_output>/<epoch>``, and
``_eval`` probe configs), then loads them back with
``training_config(path)`` / ``embedding_eval_config(path)`` and runs
the port's ``train`` / ``infer`` / ``probe`` on them, on ``--device``
(the card unless the CPU is asked for).  Nothing is passed in memory
between stages except file paths, and the rows: the stage functions take
optional rows held in memory (``rows=``, in place of ``dataset:``),
passed on to ``train`` and ``infer``, for a host without ``datasets``.

Resume-on-interrupt: each stage is skipped when its output already
exists (the pretrain's last epoch directory; the six files
:func:`mca_tpu_torch.infer.output_files` names; the probe's
``probe_result.json``); an interrupted pretrain resumes from the root
step checkpoint through a generated ``*_resume.yaml`` carrying
``restart:``, the reference's own restart workflow.

Results: one JSON line per cell appended to ``--results`` (default
``<out>/sweep_grid.jsonl``) with the probe metric suite, retrieval
metrics and the final train loss; ``--table`` (default
``<out>/SWEEP_GRID.md``) renders the markdown comparison table.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Any, Dict, List, Optional, Sequence

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------- cells

VARIANT_FLAGS: Dict[str, Dict[str, Any]] = {
    # base = ref TCGA_config1.yaml (bimodal_contrastive / non_fusion_fcl
    # / fcl all True, fcl_root [0,1,2,3], fusion_combos [4,3,2])
    "mca": {},
    # ref `_z` DSL token (configs/TCGA_config1_z_d40.yaml)
    "zorro": {"zorro": True},
    # ref TCGA_config1_EAO.yaml: eao/no_fusion/mean_pool plus the
    # reduced combo set; num_fusion_tokens stays 88 in the file and is
    # ignored by the EAO model, exactly like the reference
    "eao": {
        "eao": True,
        "no_fusion": True,
        "mean_pool": True,
        "fcl_root": [0, 1],
        "fusion_combos": [2],
    },
}
PREDROPS = (0.0, 0.15, 0.40)


def default_cells() -> List[Dict[str, Any]]:
    cells = [
        {"variant": v, "predrop": d}
        for v in ("mca", "zorro", "eao")
        for d in PREDROPS
    ]
    # the diNN cell: re-infer the MCA d15 checkpoint under heavy
    # inference-time modality dropout (ref *_d15_12i_di60 configs)
    cells.append(
        {
            "variant": "mca",
            "predrop": 0.15,
            "infer_dropout": 0.60,
        }
    )
    return cells


def cell_id(cell: Dict[str, Any]) -> str:
    cid = f"{cell['variant']}_d{int(round(cell['predrop'] * 100)):02d}"
    if cell.get("infer_dropout"):
        cid += f"_di{int(round(cell['infer_dropout'] * 100)):02d}"
    return cid


def train_cell_id(cell: Dict[str, Any]) -> str:
    """The pretrain a cell consumes (diNN cells reuse another cell's)."""
    return f"{cell['variant']}_d{int(round(cell['predrop'] * 100)):02d}"


# ------------------------------------------------------------- config IO


def _dump_yaml(obj: Dict[str, Any], path: str) -> str:
    import yaml

    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(obj, f, sort_keys=False)
    return path


def make_train_yaml(
    cell: Dict[str, Any],
    *,
    dataset: str,
    output_dir: str,
    epochs: int,
    widths: Dict[str, int],
    seed: int = 43,
    batch_size: int = 8,
    split: float = 0.1,
    n_samples: int = 600,
    lr: float = 1e-4,
    model_scale: Optional[Dict[str, int]] = None,
) -> Dict[str, Any]:
    """A reference-DSL train config (ref configs/TCGA_config1.yaml key
    surface, including dead keys the loader must tolerate).

    ``num_warmup_steps`` is sized to ~6% of the miniature run's total
    steps: the canonical default (3000) would keep the whole short run
    inside warmup, and the probe would read untrained embeddings."""
    dropout = float(cell["predrop"])
    total_steps = epochs * max(
        int(n_samples * (1 - split)) // batch_size, 1
    )
    warmup = max(20, int(0.06 * total_steps))
    cfg: Dict[str, Any] = {
        "encoder_configs": {
            m: {
                "type": "TabularEncoder",
                "num_embeddings": w,
                "max_tokens": w,
                "max_value": 100,
            }
            for m, w in widths.items()
        },
        "modality_config": {
            m: dict(
                {
                    "type": "sequence",
                    "pad_len": w,
                    "data_col_name": "values",
                    "pad_token": -10000,
                },
                **({"dropout": dropout} if dropout else {}),
            )
            for m, w in widths.items()
        },
        "num_fusion_tokens": 88,
        "ds_frac": 1.0,
        "predrop": dropout > 0,
        "batch_size": int(batch_size),
        "split": float(split),
        "random_seed": seed,  # dead key in the reference; tolerated
        "ds_seed": seed,
        "seed": seed,
        "lr": float(lr),
        "num_warmup_steps": warmup,
        "layers": 5,
        "lr_scheduler_type": "cosine",
        "epochs": int(epochs),
        "bimodal_contrastive": True,
        "non_fusion_fcl": True,
        "fcl": True,
        "fcl_root": [0, 1, 2, 3],
        "fusion_combos": [4, 3, 2],
        "loss_masking": True,  # dead key in the reference; tolerated
        "zorro": False,
        "clip": 2.0,
        "dataset": dataset,
        "output_dir": output_dir,
        # extensions of the reference: rotate epoch checkpoints, keep a
        # root step checkpoint for resume
        "checkpoint_keep": 2,
        "n_step_checkpoint": 50,
    }
    if model_scale:
        cfg.update(model_scale)
    cfg.update(VARIANT_FLAGS[cell["variant"]])
    return cfg


def make_infer_yaml(
    train_cfg: Dict[str, Any],
    *,
    restart: str,
    output_dir: str,
    infer_dropout: Optional[float] = None,
) -> Dict[str, Any]:
    """An ``_Ni``-style inference config: the train config plus
    ``restart:`` + fixed ``output_dir`` (ref TCGA_config1_60i.yaml);
    ``infer_dropout`` makes it a ``diNN`` config (extra modality
    dropout applied at inference, ref *_di60 configs)."""
    cfg = json.loads(json.dumps(train_cfg))  # deep copy
    cfg["restart"] = restart
    cfg["output_dir"] = output_dir
    if infer_dropout:
        cfg["predrop"] = True
        for m in cfg["modality_config"]:
            cfg["modality_config"][m]["dropout"] = float(infer_dropout)
    return cfg


def make_eval_yaml(
    *,
    embedding_dir: str,
    output_dir: str,
    epochs: int,
    embedding_key: str = "fusion",
) -> Dict[str, Any]:
    """An ``_eval`` probe config (ref configs/TCGA_60i_eval.yaml).

    ``scan_epochs`` runs the epoch loop on the device
    (:mod:`mca_tpu_torch.probe`), reading a record every
    ``metrics_every`` epochs; warmup scales with the reference's
    1000/10001 proportion."""
    return {
        "embedding_dir": embedding_dir,
        "rank_metrics": True,
        "model_type": "linear",
        "epochs": int(epochs),
        "num_warmup_steps": max(10, epochs // 10),
        "loss_type": "BCE",
        "metric": "F1",
        "task": -1,
        "lr": 1e-4,
        "scan_epochs": True,
        "metrics_every": 20,
        "embedding_key": embedding_key,
        "output_dir": output_dir,
    }


# -------------------------------------------------------------- stages


def sweep_rows(*, n_samples: int, widths, seed: int) -> List[Dict[str, Any]]:
    """The grid's clustered-synthetic TCGA rows."""
    from mca_tpu_torch.data.synthetic import make_tcga_like

    return make_tcga_like(
        n_samples,
        widths=dict(widths),
        n_classes=5,
        p_missing=0.10,  # the paper's base setting is sparsely-modal
        seed=seed,
        clustered=True,  # class-separable latent: the probe has signal
    )


def ensure_dataset(path: str, *, n_samples: int, widths, seed: int) -> str:
    if os.path.isdir(path) and os.listdir(path):
        logger.info("dataset: reusing %s", path)
        return path
    from mca_tpu_torch.data.synthetic import to_hf_dataset

    samples = sweep_rows(n_samples=n_samples, widths=widths, seed=seed)
    to_hf_dataset(samples).save_to_disk(path)
    logger.info("dataset: wrote %s (%d samples)", path, n_samples)
    return path


def _final_epoch_dir(output_dir: str, epochs: int) -> str:
    return os.path.join(output_dir, str(epochs - 1))


def run_train(yaml_path: str, epochs: int, device: str = "cuda",
              rows: Optional[Sequence[Dict[str, Any]]] = None) -> str:
    """Run (or resume, or skip) the pretrain described by a DSL yaml;
    ``rows`` in place of its ``dataset:``."""
    from mca_tpu_torch.config import training_config
    from mca_tpu_torch.train import train

    cfg = training_config(yaml_path)
    final = _final_epoch_dir(cfg.output_dir, epochs)
    if os.path.isdir(final):
        logger.info("train: %s complete, skipping", cfg.output_dir)
        return cfg.output_dir
    if os.path.isdir(os.path.join(cfg.output_dir, "state")):
        # interrupted mid-run: resume from the root step checkpoint via
        # a generated restart config — the reference's restart workflow
        resume_path = yaml_path.replace(".yaml", "_resume.yaml")
        import yaml as _yaml

        with open(yaml_path) as f:
            d = _yaml.safe_load(f)
        d["restart"] = cfg.output_dir
        _dump_yaml(d, resume_path)
        logger.info("train: resuming %s via %s", cfg.output_dir, resume_path)
        cfg = training_config(resume_path)
    return train(cfg, device, rows=rows)


def run_infer(yaml_path: str, device: str = "cuda",
              rows: Optional[Sequence[Dict[str, Any]]] = None) -> str:
    """Run (or skip, when every file it writes is there) the inference a
    ``_Ni`` yaml describes; ``rows`` in place of its ``dataset:``."""
    from mca_tpu_torch.config import training_config
    from mca_tpu_torch.infer import infer, output_files

    cfg = training_config(yaml_path)
    if all(os.path.exists(p) for p in output_files(cfg.output_dir)):
        logger.info("infer: %s complete, skipping", cfg.output_dir)
        return cfg.output_dir
    os.makedirs(cfg.output_dir, exist_ok=True)
    infer(cfg, device, rows=rows)
    return cfg.output_dir


def run_probe(yaml_path: str, device: str = "cuda") -> Dict[str, Any]:
    from mca_tpu_torch.config import embedding_eval_config
    from mca_tpu_torch.probe import probe

    cfg = embedding_eval_config(yaml_path)
    marker = os.path.join(cfg.output_dir, "probe_result.json")
    if os.path.exists(marker):
        logger.info("probe: %s complete, skipping", cfg.output_dir)
        with open(marker) as f:
            return json.load(f)
    os.makedirs(cfg.output_dir, exist_ok=True)
    metrics = probe(cfg, device)
    result = {
        k: float(v)
        for k, v in metrics.items()
        if isinstance(v, (int, float)) or hasattr(v, "item")
    }
    with open(marker, "w") as f:
        json.dump(result, f, indent=1)
    return result


def _read_retrieval(probe_dir: str) -> Dict[str, float]:
    """Fusion-retrieval numbers from the probe's JSONL log (written by
    probe.log_rank_metrics as ``{modality}_{split}_{metric}`` keys).
    Averaged over modalities for the summary row."""
    path = os.path.join(probe_dir, "metrics.jsonl")
    acc: Dict[str, List[float]] = {}
    try:
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                for k, v in row.items():
                    for split in ("train", "test"):
                        for metric in (
                            "median_rank", "r1", "r5", "r10",
                        ):
                            if k.endswith(f"_{split}_{metric}"):
                                acc.setdefault(
                                    f"{split}_{metric}", []
                                ).append(float(v))
    except FileNotFoundError:
        return {}
    return {
        f"{k}_mean": float(sum(vals) / len(vals))
        for k, vals in acc.items()
    }


def _read_final_train_loss(train_dir: str) -> Optional[float]:
    path = os.path.join(train_dir, "metrics.jsonl")
    loss = None
    try:
        with open(path) as f:
            for line in f:
                row = json.loads(line)
                if "total_loss" in row:
                    loss = float(row["total_loss"])
    except FileNotFoundError:
        pass
    return loss


# ---------------------------------------------------------------- sweep


def run_sweep(args, device: str = "cuda",
              rows: Optional[Sequence[Dict[str, Any]]] = None) -> List[Dict[str, Any]]:
    """The grid's cells (``args`` as :func:`main` parses them); ``rows``
    in place of the synthetic dataset (``args.dataset`` and the one this
    writes)."""
    out = os.path.abspath(args.out)
    results = args.results or os.path.join(out, "sweep_grid.jsonl")
    os.makedirs(out, exist_ok=True)
    cfg_dir = os.path.join(out, "configs")
    runs = os.path.join(out, "runs")

    # --scale parity (default): the JAX package's cross-implementation
    # parity recipe (dim 128, 3 layers, batch 16), which learns in a few
    # hundred steps; the canonical TCGA_config1 scale needs the
    # reference's long runs before the contrastive loss leaves chance;
    # --scale canonical remains available for long runs.
    if args.tiny:
        widths = {"gene": 24, "protein": 12, "methylation": 20,
                  "mirna": 16}
        model_scale = {
            "hidden_size": 32, "layers": 2, "heads": 2,
            "dim_head": 16, "num_fusion_tokens": 22,
        }
        batch_size, split = 4, 0.25
    elif args.scale == "parity":
        widths = {"gene": 120, "protein": 60, "methylation": 100,
                  "mirna": 80}
        model_scale = {
            "hidden_size": 128, "layers": 3, "heads": 4,
            "dim_head": 32, "num_fusion_tokens": 22,
        }
        batch_size, split = 16, 0.25
    else:  # canonical
        widths = {
            "gene": 800,
            "protein": 198,
            "methylation": 800,
            "mirna": 662,
        }
        model_scale = None
        batch_size, split = 8, 0.1
    dataset = "" if rows is not None else args.dataset or ensure_dataset(
        os.path.join(out, "dataset"),
        n_samples=args.n_samples,
        widths=widths,
        seed=7,
    )

    done: Dict[str, Dict[str, Any]] = {}
    if os.path.exists(results):
        with open(results) as f:
            for line in f:
                row = json.loads(line)
                done[row["cell"]] = row

    cells = default_cells()
    if args.cells:
        wanted = set(args.cells.split(","))
        cells = [c for c in cells if cell_id(c) in wanted]

    records: List[Dict[str, Any]] = []
    for cell in cells:
        cid = cell_id(cell)
        if cid in done:
            logger.info("cell %s: already recorded, skipping", cid)
            records.append(done[cid])
            continue
        t_start = time.time()
        tid = train_cell_id(cell)
        name = f"TCGA_sweep_{tid}"
        train_out = os.path.join(runs, tid)
        tr_yaml = os.path.join(cfg_dir, f"{name}.yaml")
        if not os.path.exists(tr_yaml):
            _dump_yaml(
                make_train_yaml(
                    cell,
                    dataset=dataset,
                    output_dir=train_out,
                    epochs=args.epochs,
                    widths=widths,
                    # the eval split must still fill one drop_last
                    # batch (infer iterates both splits)
                    batch_size=batch_size,
                    split=split,
                    n_samples=args.n_samples,
                    lr=args.lr,
                    model_scale=model_scale,
                ),
                tr_yaml,
            )
        run_train(tr_yaml, args.epochs, device, rows)

        # _Ni inference config from the final epoch checkpoint
        ep = args.epochs - 1
        di = cell.get("infer_dropout")
        suffix = f"_{ep}i" + (
            f"_di{int(round(di * 100)):02d}" if di else ""
        )
        infer_out = os.path.join(runs, cid + "_infer")
        ni_yaml = os.path.join(cfg_dir, f"{name}{suffix}.yaml")
        import yaml as _yaml

        with open(tr_yaml) as f:
            tr_dict = _yaml.safe_load(f)
        _dump_yaml(
            make_infer_yaml(
                tr_dict,
                restart=os.path.join(train_out, str(ep)),
                output_dir=infer_out,
                infer_dropout=di,
            ),
            ni_yaml,
        )
        run_infer(ni_yaml, device, rows)

        # _eval probe config
        probe_out = os.path.join(runs, cid + "_probe")
        ev_yaml = os.path.join(cfg_dir, f"{name}{suffix}_eval.yaml")
        flags = VARIANT_FLAGS[cell["variant"]]
        _dump_yaml(
            make_eval_yaml(
                embedding_dir=infer_out,
                output_dir=probe_out,
                epochs=args.probe_epochs,
                # no_fusion families (EAO) emit no 'fusion' key — read
                # the fcl_root combo, the reference's fusion alias
                # (see probe.resolve_embedding_key)
                embedding_key=(
                    "combo:" + ",".join(
                        str(i) for i in flags["fcl_root"]
                    )
                    if flags.get("no_fusion")
                    else "fusion"
                ),
            ),
            ev_yaml,
        )
        metrics = run_probe(ev_yaml, device)

        row = {
            "cell": cid,
            "variant": cell["variant"],
            "predrop": cell["predrop"],
            "infer_dropout": cell.get("infer_dropout", 0.0),
            "epochs": args.epochs,
            "n_samples": args.n_samples,
            "final_train_loss": _read_final_train_loss(train_out),
            "probe": {
                k: v
                for k, v in metrics.items()
                if k.startswith("eval_") or k.startswith("train_")
            },
            "retrieval": _read_retrieval(probe_out),
            "configs": {
                "train": os.path.relpath(tr_yaml, out),
                "infer": os.path.relpath(ni_yaml, out),
                "eval": os.path.relpath(ev_yaml, out),
            },
            "wallclock_s": round(time.time() - t_start, 1),
            "device": _device_kind(device),
        }
        os.makedirs(os.path.dirname(os.path.abspath(results)), exist_ok=True)
        with open(results, "a") as f:
            f.write(json.dumps(row) + "\n")
        logger.info(
            "cell %s: eval_f1=%s eval_auroc=%s (%.0fs)",
            cid,
            row["probe"].get("eval_f1"),
            row["probe"].get("eval_auroc"),
            row["wallclock_s"],
        )
        records.append(row)
    return records


def _device_kind(device: str) -> str:
    import torch

    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def _fmt(v: Any, nd: int = 3) -> str:
    return "-" if v is None else f"{float(v):.{nd}f}"


def render_table(rows: List[Dict[str, Any]], path: str) -> str:
    """The committed markdown comparison table (the paper's product:
    MCA vs MMA vs EAO under modality dropout)."""
    by_cell = {r["cell"]: r for r in rows}
    lines = [
        "# Sweep grid — {MCA, MMA/zorro, EAO} x modality predrop",
        "",
        "Generated by `python -m mca_tpu_torch.tools.sweep` on "
        "clustered-synthetic TCGA (the results file holds the raw rows; "
        "the pipeline: pretrain -> `_Ni` restart inference -> `_eval` "
        "probe, all chained through reference-DSL YAML files).",
        "",
        "| cell | variant | predrop | infer-drop | probe F1 | AUROC "
        "| AUPRC | acc | R@1 (test, mean) | med-rank | train loss |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        p = r.get("probe", {})
        rt = r.get("retrieval", {})
        lines.append(
            "| {cell} | {variant} | {pd:.2f} | {di:.2f} | {f1} | {au} "
            "| {ap} | {acc} | {r1} | {mr} | {loss} |".format(
                cell=r["cell"],
                variant=r["variant"],
                pd=r["predrop"],
                di=r.get("infer_dropout", 0.0),
                f1=_fmt(p.get("eval_f1")),
                au=_fmt(p.get("eval_auroc")),
                ap=_fmt(p.get("eval_auprc")),
                acc=_fmt(p.get("eval_accuracy")),
                r1=_fmt(rt.get("test_r1_mean")),
                mr=_fmt(rt.get("test_median_rank_mean"), 1),
                loss=_fmt(r.get("final_train_loss"), 3),
            )
        )
    # the qualitative ordering note the sweep exists to produce
    notes = ["", "## Ordering vs the paper's qualitative claim", ""]
    for d in PREDROPS:

        def f1(v, d=d):
            r = by_cell.get(f"{v}_d{int(round(d * 100)):02d}")
            return (r or {}).get("probe", {}).get("eval_f1")

        trio = {v: f1(v) for v in ("mca", "zorro", "eao")}
        if all(x is not None for x in trio.values()):
            order = sorted(trio, key=trio.get, reverse=True)
            notes.append(
                f"- predrop {d:.2f}: "
                + " > ".join(f"{v} ({trio[v]:.3f})" for v in order)
            )
    d15 = by_cell.get("mca_d15", {}).get("probe", {}).get("eval_f1")
    di60 = (
        by_cell.get("mca_d15_di60", {}).get("probe", {}).get("eval_f1")
    )
    if d15 is not None and di60 is not None:
        notes.append(
            f"- inference dropout 0.60 on the mca_d15 checkpoint: "
            f"F1 {d15:.3f} -> {di60:.3f}"
        )
    lines += notes + [""]
    text = "\n".join(lines)
    with open(path, "w") as f:
        f.write(text)
    return text


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments (what :func:`run_sweep` takes)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default="sweep_out")
    ap.add_argument("--dataset", default=None, help="reuse an HF dataset dir")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--probe-epochs", type=int, default=2000)
    ap.add_argument("--n-samples", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument(
        "--scale", choices=("parity", "canonical"), default="parity",
        help="model/data scale of the grid (see run_sweep comment)",
    )
    ap.add_argument(
        "--cells", default=None, help="comma-separated cell ids to run"
    )
    ap.add_argument("--results", default=None,
                    help="the results JSONL (default <out>/sweep_grid.jsonl)")
    ap.add_argument("--table", default=None,
                    help="the markdown table (default <out>/SWEEP_GRID.md; '' for none)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument(
        "--tiny",
        action="store_true",
        help="tiny widths for CPU smoke tests",
    )
    return ap.parse_args(argv)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    out = os.path.abspath(args.out)
    args.results = args.results or os.path.join(out, "sweep_grid.jsonl")
    table = os.path.join(out, "SWEEP_GRID.md") if args.table is None else args.table
    rows = run_sweep(args, args.device)
    if table:
        print(render_table(rows, table))
    print(json.dumps({"cells": len(rows), "results": args.results}))


if __name__ == "__main__":
    main()
