"""The port's preprocessors and ``to_hf_dataset`` against the JAX package's.

The raw inputs are written here: TCGA's five PANCAN-shaped tables (gene
and methylation TSVs, a miRNA CSV with corrected and uncorrected rows, an
RPPA TSV with missing values, a TCGA-CDR CSV that lacks one patient) and
CMU-MOSEI's five aligned ``.csd`` containers (one segment missing from one
file).  Both packages' ``process`` write an HF dataset; the two must hold
the same rows exactly (the same pandas / numpy code on the same tables).
The table helpers are held on ``tests/test_preprocess.py``'s frames.
"""

import numpy as np
import pytest

pd = pytest.importorskip("pandas")
h5py = pytest.importorskip("h5py")
hfds = pytest.importorskip("datasets")

from mca_tpu.data import preprocess_cmu as jax_cmu  # noqa: E402
from mca_tpu.data import preprocess_tcga as jax_tcga  # noqa: E402
from mca_tpu.data.synthetic import make_cmu_like, make_tcga_like  # noqa: E402
from mca_tpu.data.synthetic import to_hf_dataset as jax_to_hf  # noqa: E402
from mca_tpu_torch.data import preprocess_cmu as port_cmu  # noqa: E402
from mca_tpu_torch.data import preprocess_tcga as port_tcga  # noqa: E402
from mca_tpu_torch.data.synthetic import to_hf_dataset  # noqa: E402

N_SAMPLES = 9


def _write_tcga(root):
    rng = np.random.default_rng(0)
    ids = [f"TCGA-02-{1000 + i:04d}-01A-01D-0186-05" for i in range(N_SAMPLES)]
    gene = pd.DataFrame(rng.gamma(2.0, size=(12, N_SAMPLES)), columns=ids)
    gene.iloc[3, 2] = 0.0  # a zero: the row drops in gene mode
    gene.iloc[7, 4] = np.nan  # a NaN row drops
    gene.insert(0, "gene_id", [f"g{i}" for i in range(12)])
    gene.to_csv(root / "gene.tsv", sep="\t", index=False)
    meth = pd.DataFrame(rng.random((10, N_SAMPLES)), columns=ids)
    meth.insert(0, "Composite Element REF", [f"cg{i}" for i in range(10)])
    meth.to_csv(root / "meth.tsv", sep="\t", index=False)
    mirna = pd.DataFrame(rng.normal(size=(8, N_SAMPLES)), columns=ids)
    mirna.insert(0, "Correction", ["Corrected", "Uncorrected"] * 4)
    mirna.insert(0, "Genes", [f"mir{i}" for i in range(8)])
    mirna.to_csv(root / "mirna.csv", index=False)
    rppa = pd.DataFrame(rng.normal(size=(N_SAMPLES, 5)), columns=[f"p{i}" for i in range(5)])
    rppa.iloc[1, 2] = np.nan  # becomes the -10000 marker
    rppa.insert(0, "TumorType", ["BRCA"] * N_SAMPLES)
    rppa.insert(0, "SampleID", ids)
    rppa.to_csv(root / "rppa.tsv", sep="\t", index=False)
    patients = [f"TCGA-02-{1000 + i:04d}" for i in range(N_SAMPLES - 1)]  # the last absent
    cdr = pd.DataFrame({"n": range(len(patients)), "bcr_patient_barcode": patients,
                        "type": [("BRCA", "LUAD", "KIRC")[i % 3] for i in range(len(patients))]})
    cdr.to_csv(root / "cdr.csv", index=False)
    return dict(gene_path=str(root / "gene.tsv"), mirna_path=str(root / "mirna.csv"),
                methylation_path=str(root / "meth.tsv"), rppa_path=str(root / "rppa.tsv"),
                cdr_path=str(root / "cdr.csv"), n_gene=4, n_methylation=3)


def _rows_of(path):
    ds = hfds.load_from_disk(str(path))
    return ds.column_names, ds.to_list()


def _assert_same_dataset(a, b):
    cols_a, rows_a = _rows_of(a)
    cols_b, rows_b = _rows_of(b)
    assert cols_a == cols_b
    assert rows_a == rows_b
    return rows_a


def test_tcga_process_matches_jax(tmp_path):
    args = _write_tcga(tmp_path)
    jax_tcga.process(out_path=str(tmp_path / "jax"), **args)
    port_tcga.process(out_path=str(tmp_path / "port"), **args)
    rows = _assert_same_dataset(tmp_path / "jax", tmp_path / "port")
    assert len(rows) == N_SAMPLES
    assert [len(rows[0][m]["values"]) for m in ("gene", "protein", "methylation", "mirna")] \
        == [4, 5, 3, 4]
    assert rows[1]["protein"]["values"][2] == port_tcga.MISSING_MARKER
    assert rows[-1]["Labels"]["data"] == [0.0, 0.0, 0.0]  # absent from the CDR table


def test_tcga_helpers_match_jax():
    """``tests/test_preprocess.py``'s frames through both packages."""
    df = pd.DataFrame({"s1": [1.0, 1.0, 0.0, 5.0], "s2": [1.0, 2.0, 0.0, -5.0],
                       "s3": [1.0, 3.0, 0.0, 5.0]}, index=["flat", "mid", "zeros", "wild"])
    for kw in ({}, {"drop_zeros": True}):
        pd.testing.assert_frame_equal(port_tcga.top_variance_rows(df, 2, **kw),
                                      jax_tcga.top_variance_rows(df, 2, **kw))
    cdr = pd.DataFrame({"type": ["BRCA", "LUAD", "BRCA"]},
                       index=["02_0001", "02_0002", "02_0003"])
    ids = ["02_0001_01C", "02_0002_01A", "99_9999_01A"]
    got, want = port_tcga.one_hot_labels(ids, cdr), jax_tcga.one_hot_labels(ids, cdr)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == ["BRCA", "LUAD"]
    assert port_tcga.normalize_sample_id("TCGA-02-0001-01C-01D-0186-05") == "02_0001_01C"


def _write_csd(root, rng):
    dims = {"Labels": 7, "COVAREP": 5, "FACET": 3, "OpenFace": 6, "glove_vectors": 4}
    for name, fname in port_cmu.DEFAULT_FILES.items():
        with h5py.File(root / fname, "w") as f:
            grp = f.create_group(name).create_group("data")
            for key in ("seg_a", "seg_b", "seg_c"):
                if name == "FACET" and key == "seg_b":
                    continue  # a segment one modality lacks is skipped
                grp.create_group(key).create_dataset(
                    "features",
                    data=rng.normal(size=(int(rng.integers(2, 6)), dims[name])).astype(np.float32))


def test_cmu_process_matches_jax(tmp_path):
    _write_csd(tmp_path, np.random.default_rng(1))
    jax_cmu.process(str(tmp_path), str(tmp_path / "jax"))
    port_cmu.process(str(tmp_path), str(tmp_path / "port"))
    rows = _assert_same_dataset(tmp_path / "jax", tmp_path / "port")
    assert len(rows) == 2
    assert list(port_cmu.DEFAULT_FILES) == list(jax_cmu.DEFAULT_FILES)


@pytest.mark.parametrize("kind", ["tcga", "cmu"])
def test_to_hf_dataset_matches_jax(tmp_path, kind):
    rows = (make_tcga_like(6, widths={"gene": 5, "protein": 3}, p_missing=0.3, seed=2)
            if kind == "tcga" else
            make_cmu_like(5, shapes={"COVAREP": (3, 6), "glove_vectors": (2, 4)},
                          p_missing=0.3, seed=2))
    to_hf_dataset(rows).save_to_disk(str(tmp_path / "port"))
    jax_to_hf(rows).save_to_disk(str(tmp_path / "jax"))
    _assert_same_dataset(tmp_path / "jax", tmp_path / "port")
    assert to_hf_dataset(rows).format["type"] == "numpy"
