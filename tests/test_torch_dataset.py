"""The port's data setup and loader against the JAX package's.

A tiny TCGA-shaped dataset (40 rows, widths 12/8/10/6, a fifth of the
modalities missing) is written with ``to_hf_dataset(...).save_to_disk``
as ``tests/test_e2e.py`` does.  Both packages split it, shuffle it per
epoch from the same seed and collate it; every batch must be equal bit
for bit: for epochs 0 and 1, with the rows preloaded or read from the
arrow buffers of the index-mapped split, after ``skip_batches`` and for
``first_batch``.  The port's split of rows held in memory must give the
rows the HF split gives.  An epoch of CMU-shaped rows collated into host
blocks, as under CUDA, equals the collator's numpy output.
"""

import numpy as np
import pytest
import torch

from mca_tpu.data import dataset as jax_ds
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config, to_hf_dataset
from mca_tpu_torch.data import dataset as port_ds
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.synthetic import make_cmu_like
from tests.test_torch_staging import unpinned_cuda_blocks  # noqa: F401 (fixture)

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
MODALITIES = tiny_config("tcga", widths=WIDTHS)["modality_config"]
BS, SEED, DS_SEED = 8, 42, 43


@pytest.fixture(scope="module")
def rows():
    return make_tcga_like(40, widths=WIDTHS, p_missing=0.2, seed=0)


@pytest.fixture(scope="module")
def ds_path(rows, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ds") / "ds")
    to_hf_dataset(rows).save_to_disk(path)
    return path


def assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for m in w:
            assert g[m].keys() == w[m].keys(), m
            for k in w[m]:
                assert g[m][k].dtype == w[m][k].dtype, (m, k)
                np.testing.assert_array_equal(g[m][k], w[m][k], err_msg=f"{m}.{k}")


def loaders(ds_path, preload, split=0.2, **kw):
    jdata = jax_ds.setup_data(ds_path, split=split, ds_seed=DS_SEED)
    pdata = port_ds.setup_data(ds_path, split=split, ds_seed=DS_SEED)
    jl = jax_ds.BatchedLoader(jdata["train"], JaxCollator(MODALITIES), BS,
                              shuffle=True, seed=SEED, preload=preload, **kw)
    pl = port_ds.BatchedLoader(pdata["train"], MultimodalCollator(MODALITIES), BS,
                               shuffle=True, seed=SEED, preload=preload, **kw)
    return jl, pl


@pytest.mark.parametrize("preload", [True, False])
@pytest.mark.parametrize("epoch", [0, 1])
def test_batches_match_jax(ds_path, preload, epoch):
    jl, pl = loaders(ds_path, preload)
    jl.set_epoch(epoch)
    pl.set_epoch(epoch)
    assert len(pl) == len(jl) == 4
    assert_batches_equal(list(pl), list(jl))


def test_epochs_are_shuffled_apart(ds_path):
    """The fault the loader repairs: the port once cycled the rows in
    one fixed order.  Epochs 0 and 1 must differ, and each must differ
    from the split's own order."""
    _, pl = loaders(ds_path, True)
    e0 = list(pl)
    pl.set_epoch(1)
    e1 = list(pl)
    plain = port_ds.BatchedLoader(pl.dataset, pl.collator, BS)
    in_order = list(plain)
    assert not np.array_equal(e0[0]["gene"]["values"], e1[0]["gene"]["values"])
    assert not np.array_equal(e0[0]["gene"]["values"], in_order[0]["gene"]["values"])


@pytest.mark.parametrize("preload", [True, False])
@pytest.mark.parametrize("skip", [1, 3])
def test_skip_batches_matches_jax(ds_path, preload, skip):
    jl, pl = loaders(ds_path, preload)
    for loader in (jl, pl):
        loader.set_epoch(1)
        loader.skip_batches(skip)
    assert_batches_equal(list(pl), list(jl))
    # one-shot: the next pass starts at the first batch again
    assert len(list(pl)) == 4


@pytest.mark.parametrize("preload", [True, False])
def test_preload_and_arrow_paths_agree(ds_path, preload):
    """The arrow fast path must read the index-mapped split's rows, not
    the underlying table's rows at those positions."""
    _, arrow = loaders(ds_path, False)
    _, pre = loaders(ds_path, True)
    assert_batches_equal(list(arrow), list(pre))


@pytest.mark.parametrize("preload", [True, False])
def test_first_batch_matches_jax_and_wraps_a_tiny_split(ds_path, preload):
    jdata = jax_ds.setup_data(ds_path, split=0.1, ds_seed=DS_SEED)
    pdata = port_ds.setup_data(ds_path, split=0.1, ds_seed=DS_SEED)
    assert len(pdata["test"]) == 4 < BS
    jl = jax_ds.BatchedLoader(jdata["test"], JaxCollator(MODALITIES), BS, preload=preload)
    pl = port_ds.BatchedLoader(pdata["test"], MultimodalCollator(MODALITIES), BS,
                               preload=preload)
    got, want = pl.first_batch(), jl.first_batch()
    assert_batches_equal([got], [want])
    assert got["gene"]["values"].shape[0] == BS
    assert len(pl) == 0 and list(pl) == []


def test_prefetch_gives_the_same_batches(ds_path):
    _, pl = loaders(ds_path, True)
    _, pf = loaders(ds_path, True, prefetch=2)
    assert_batches_equal(list(pf), list(pl))


CMU_SHAPES = {"COVAREP": (74, 30), "FACET": (35, 9), "OpenFace": (713, 9),
              "glove_vectors": (300, 5)}  # CMU-MOSEI's widths, short pad lengths
CMU_MODALITIES = {m: {"type": "embedded_sequence", "pad_len": n, "data_col_name": "data",
                      "pad_token": -10000, "embedding_size": w}
                  for m, (w, n) in CMU_SHAPES.items()}


@pytest.mark.parametrize("prefetch", [0, 2])
def test_cmu_epoch_in_host_blocks_equals_the_collators_output(prefetch, unpinned_cuda_blocks,
                                                              monkeypatch):
    """With CUDA initialised the loader collates into host blocks
    (``staging.empty``; stubbed unpinned here): every batch of an epoch at
    CMU's widths, all held to the end, equals the collator's numpy output
    on the same rows, and no two batches share memory."""
    rows = make_cmu_like(40, shapes={m: (w, n + 3) for m, (w, n) in CMU_SHAPES.items()},
                         p_missing=0.3, seed=5)
    collator = MultimodalCollator(CMU_MODALITIES, labels="Labels")
    order = np.arange(len(rows))
    np.random.default_rng(SEED).shuffle(order)
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_initialized", lambda: False)  # numpy's own memory
        want = [collator([rows[i] for i in order[k * BS:(k + 1) * BS]])
                for k in range(len(rows) // BS)]
    loader = port_ds.BatchedLoader(rows, collator, BS, shuffle=True, seed=SEED, prefetch=prefetch)
    got = list(loader)
    assert_batches_equal(got, want)
    cols = [v for b in got for f in b.values() for v in f.values()]
    assert len(unpinned_cuda_blocks) == len(cols) == len(got) * (2 * len(CMU_SHAPES) + 1)
    assert all(isinstance(v.base, torch.Tensor) for v in cols)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(cols) for b in cols[i + 1:])


def test_prefetch_reraises_the_producers_error(rows):
    def collate(batch):
        raise KeyError("bad row")

    loader = port_ds.BatchedLoader(rows, collate, BS, prefetch=2)
    with pytest.raises(KeyError, match="bad row"):
        list(loader)


def _rows_of(split):
    return [split[i] for i in range(len(split))]


def assert_rows_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for m in w:
            if w[m] is None or g[m] is None:
                assert g[m] is None and w[m] is None, m
                continue
            for k in w[m]:
                if w[m][k] is None:
                    assert g[m][k] is None, (m, k)
                else:
                    np.testing.assert_array_equal(np.asarray(g[m][k]), np.asarray(w[m][k]))


@pytest.mark.parametrize(
    "split,ds_frac,predrop",
    [(0.2, 1.0, False), (0.25, 0.5, False), (0.2, 1.0, True), (3, 0.75, True)],
)
def test_setup_data_matches_jax(ds_path, rows, split, ds_frac, predrop):
    mods = {m: dict(c, dropout=0.3 if m in ("gene", "mirna") else 0.0)
            for m, c in MODALITIES.items()}
    kw = dict(split=split, ds_frac=ds_frac, ds_seed=DS_SEED, predrop=predrop, predrop_config=mods)
    jdata = jax_ds.setup_data(ds_path, **kw)
    pdata = port_ds.setup_data(ds_path, **kw)
    mem = port_ds.setup_data(rows, **kw)
    for part in ("train", "test"):
        want = _rows_of(jdata[part])
        assert_rows_equal(_rows_of(pdata[part]), want)
        # rows held in memory split as the HF split splits them
        assert_rows_equal(mem[part], want)
    if predrop:
        dropped = sum(r["gene"]["values"] is None for r in mem["train"] + mem["test"])
        assert dropped > 0


def test_rows_in_memory_batch_like_the_dataset(ds_path, rows):
    pdata = port_ds.setup_data(ds_path, split=0.2, ds_seed=DS_SEED)
    mem = port_ds.setup_data(rows, split=0.2, ds_seed=DS_SEED)
    collate = MultimodalCollator(MODALITIES)
    for preload in (True, False):
        a = port_ds.BatchedLoader(mem["train"], collate, BS, shuffle=True, seed=SEED,
                                  preload=preload)
        b = port_ds.BatchedLoader(pdata["train"], collate, BS, shuffle=True, seed=SEED)
        assert_batches_equal(list(a), list(b))


@pytest.mark.parametrize("dropout", [0.0, 0.3, 0.5])
def test_batch_dropout_matches_jax(dropout):
    rng = np.random.default_rng(1)
    batch = {"attention_mask": rng.integers(0, 2, (10, 6)), "tokens": rng.normal(size=(10, 6))}
    jd = jax_ds.BatchDropout(dropout=dropout, random_seed=7)
    pd = port_ds.BatchDropout(dropout=dropout, random_seed=7)
    for _ in range(3):
        j, p = jd(batch), pd(batch)
        for k in batch:
            np.testing.assert_array_equal(p[k], j[k])


@pytest.mark.parametrize("mode", ["delete", "fill"])
def test_batch_predropout_matches_jax(mode):
    jd = jax_ds.BatchPreDropout(mode=mode, dropout=0.5, random_seed=3,
                                kvs={"values": -1.0})
    pd = port_ds.BatchPreDropout(mode=mode, dropout=0.5, random_seed=3,
                                 kvs={"values": -1.0})
    for i in range(8):
        value = {"values": np.arange(4, dtype=np.float32) + i}
        j, p = jd(value), pd(value)
        assert (j is None) == (p is None)
        assert j.keys() == p.keys()
        for k in j:
            if j[k] is None:
                assert p[k] is None
            else:
                np.testing.assert_array_equal(p[k], j[k])
