"""TCGA pan-cancer preprocessing -> HF dataset, ported from
``mca_tpu/data/preprocess_tcga.py`` (framework-free: the port keeps its
own copy).

A script-form rebuild of the reference's notebook pipeline
(``data/process_tcga.ipynb``), producing the dataset schema the TCGA
configs consume:

rows ``{"tcga_index": str, "gene": {"values": [800]},
"protein": {"values": [198]}, "methylation": {"values": [800]},
"mirna": {"values": [662]}, "Labels": {"data": one-hot cancer type}}``

Pipeline (per the notebook, cells 2-61):
- gene expression: drop NaN rows, zeros -> NaN, keep the top-N rows by
  variance (N=800),
- methylation: top-N rows by variance,
- miRNA: keep ``Correction == "Corrected"`` rows,
- RPPA protein: transpose to sample-major; missing values become the
  ``-10000`` pad/missing marker,
- sample ids normalised to ``"_".join(id.split('-')[1:4])``, tables
  intersected on common samples, duplicates keep-last,
- per-column z-score normalisation,
- one-hot cancer-type ``Labels`` from the TCGA-CDR table ``type``
  column (all-zeros when the sample is absent).

Inputs are the public PANCAN files named in the notebook; run:
``python -m mca_tpu_torch.data.preprocess_tcga --gene ... --out tcga_dataset``.
``pandas`` and ``datasets`` are imported inside :func:`process` only.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

MISSING_MARKER = -10000.0


def normalize_sample_id(sample_id: str) -> str:
    return "_".join(sample_id.split("-")[1:4])


def top_variance_rows(df, n: int, drop_zeros: bool = False):
    """Keep the n highest-variance feature rows (features x samples)."""
    df = df.dropna()
    if drop_zeros:
        # zeros are missing markers in the gene table (notebook cell
        # 19); rows that become NaN are dropped before ranking
        df = df.replace(0, np.nan).dropna()
    order = df.var(axis=1).sort_values().index
    return df.reindex(order, axis=0).tail(n)


def corrected_mirna(df):
    """Keep corrected miRNA rows (notebook cell 7)."""
    return (
        df[df["Correction"] == "Corrected"]
        .set_index("Genes")
        .drop("Correction", axis=1)
    )


def sample_major(df):
    """features-x-samples -> samples-x-features with normalised ids."""
    out = df.T
    out.index = out.index.map(normalize_sample_id)
    return out


def intersect_samples(tables: Dict[str, "object"]):
    """Restrict every table to the common sample ids (keep-last dups)."""
    common = None
    for df in tables.values():
        ids = set(df.index.to_list())
        common = ids if common is None else (common & ids)
    joint = sorted(common)
    out = {}
    for name, df in tables.items():
        sub = df.loc[joint]
        out[name] = sub[~sub.index.duplicated(keep="last")]
    return out


def zscore(df):
    return (df - df.mean()) / df.std()


def one_hot_labels(
    sample_ids: List[str], cdr_df, type_order: Optional[List[str]] = None
):
    """One-hot cancer-type vectors from the TCGA-CDR table.

    ``cdr_df`` is indexed by normalised patient id with a ``type``
    column; samples missing from the table get all-zeros (notebook
    cell 58).
    """
    if type_order is None:
        type_order = list(dict.fromkeys(cdr_df["type"]))
    index = {t: i for i, t in enumerate(type_order)}
    labels = []
    for sid in sample_ids:
        patient = "_".join(sid.split("_")[:-1])
        vec = np.zeros(len(index), dtype=np.float32)
        ctype = (
            cdr_df["type"].get(patient)
            if patient in cdr_df.index
            else None
        )
        if ctype is not None and ctype in index:
            vec[index[ctype]] = 1.0
        labels.append(vec)
    return np.stack(labels), type_order


def build_rows(tables: Dict[str, "object"], labels: np.ndarray):
    names = list(tables.keys())
    first = tables[names[0]]
    rows = []
    for i, sid in enumerate(first.index):
        row = {"tcga_index": sid}
        for name, df in tables.items():
            row[name] = {
                "values": df.iloc[i].to_numpy(np.float32).tolist()
            }
        row["Labels"] = {"data": labels[i].tolist()}
        rows.append(row)
    return rows


def process(
    gene_path: str,
    mirna_path: str,
    methylation_path: str,
    rppa_path: str,
    cdr_path: str,
    out_path: str,
    n_gene: int = 800,
    n_methylation: int = 800,
) -> None:
    import datasets as hfds
    import pandas as pd

    df_gene = pd.read_csv(gene_path, delimiter="\t").set_index(
        "gene_id"
    )
    df_mirna = corrected_mirna(pd.read_csv(mirna_path))
    df_meth = pd.read_csv(methylation_path, delimiter="\t").set_index(
        "Composite Element REF"
    )
    df_rppa = (
        pd.read_csv(rppa_path, delimiter="\t")
        .set_index("SampleID")
        .T.drop("TumorType")
    )

    tables = {
        "gene": sample_major(
            top_variance_rows(df_gene, n_gene, drop_zeros=True)
        ),
        "protein": sample_major(df_rppa),
        "methylation": sample_major(
            top_variance_rows(df_meth, n_methylation)
        ),
        "mirna": sample_major(df_mirna),
    }
    tables = intersect_samples(tables)
    tables = {k: zscore(v) for k, v in tables.items()}
    tables["protein"] = tables["protein"].fillna(MISSING_MARKER)

    if cdr_path.endswith((".xlsx", ".xls")):
        cdr = pd.read_excel(cdr_path, index_col=1)
    else:  # csv export of TCGA-CDR works without openpyxl
        cdr = pd.read_csv(cdr_path, index_col=1)
    cdr.index = cdr.index.map(
        lambda x: "_".join(str(x).split("-")[1:])
    )
    labels, type_order = one_hot_labels(
        list(tables["gene"].index), cdr
    )

    rows = build_rows(tables, labels)
    columns = {k: [r[k] for r in rows] for k in rows[0]}
    ds = hfds.Dataset.from_dict(columns)
    ds.save_to_disk(out_path)
    print(
        f"saved {len(ds)} samples x {len(type_order)} cancer types "
        f"to {out_path}"
    )


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--gene", required=True)
    p.add_argument("--mirna", required=True)
    p.add_argument("--methylation", required=True)
    p.add_argument("--rppa", required=True)
    p.add_argument("--cdr", required=True)
    p.add_argument("--out", default="tcga_dataset")
    p.add_argument("--n-gene", type=int, default=800)
    p.add_argument("--n-methylation", type=int, default=800)
    a = p.parse_args()
    process(
        a.gene, a.mirna, a.methylation, a.rppa, a.cdr, a.out,
        a.n_gene, a.n_methylation,
    )


if __name__ == "__main__":
    main()
