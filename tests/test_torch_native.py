"""The port's C++ collate (``mca_tpu_torch.native``) against its numpy
plain versions and the JAX package's native collate, bit for bit.

Rows are made with numpy from a seed: ragged lengths, missing (None) and
empty rows, rows cut to ``pad_len``, live values equal to the pad token,
NaN and +-Inf with ``clean`` on and off.  The collators are held to the
JAX package's on TCGA- and CMU-shaped rows.  The port refuses two inputs
on both of its paths where the JAX package's native path cuts or reads
past a row: a row longer than ``pad_len`` under ``truncate: false``, and
a row of another width.  A failed ``g++`` build raises.
"""

import numpy as np
import pytest

from mca_tpu import native as jax_native
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_cmu_like, make_tcga_like, tiny_config
from mca_tpu_torch import native
from mca_tpu_torch.data.collators import EmbeddedSequenceCollator, MultimodalCollator

PAD = -10000.0


def assert_bitwise(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype,
                                                                 got.shape, want.shape)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _rows_1d(rng):
    live_pad = rng.normal(size=(6,)).astype(np.float32)
    live_pad[2] = PAD  # a live value equal to the pad token is masked too
    specials = rng.normal(size=(5,)).astype(np.float32)
    specials[[0, 3]] = [np.nan, np.inf]
    return [
        rng.normal(size=(5,)).astype(np.float32),
        None,
        rng.normal(size=(12,)).astype(np.float32),  # cut to pad_len
        np.zeros((0,), np.float32),
        live_pad,
        specials,
        np.arange(4),  # int64, cast to f32
        rng.normal(size=(2, 3)),  # float64 and 2-D, flattened
    ]


@pytest.mark.parametrize("with_mask", [True, False])
def test_pad_rows_matches_plain_and_jax_native(with_mask):
    rows = _rows_1d(np.random.default_rng(0))
    out, mask = native.pad_rows(rows, 8, PAD, with_mask=with_mask)
    plain_out, plain_mask = native.pad_rows_plain(rows, 8, PAD, with_mask=with_mask)
    jax_out, jax_mask = jax_native.pad_rows(rows, 8, PAD, with_mask=with_mask)
    assert_bitwise(out, plain_out)
    assert_bitwise(out, jax_out)
    if with_mask:
        assert_bitwise(mask, plain_mask)
        assert_bitwise(mask, jax_mask)
        assert mask[4, 2] == 1 and mask[0, 5] == 1 and mask[0, 4] == 0
    else:
        assert mask is None and plain_mask is None


def test_pad_rows_fill_matches_plain_and_jax_native():
    rows = _rows_1d(np.random.default_rng(1))
    out = native.pad_rows_fill(rows, 7, 0.0)
    assert_bitwise(out, native.pad_rows_fill_plain(rows, 7, 0.0))
    assert_bitwise(out, jax_native.pad_rows_fill(rows, 7, 0.0))
    assert (out[1] == 0).all() and (out[0, 5:] == 0).all()


def _rows_2d(rng, width=4):
    specials = rng.normal(size=(3, width)).astype(np.float32)
    specials[0, 1], specials[1, 2], specials[2, 0] = np.nan, np.inf, -np.inf
    return [
        rng.normal(size=(3, width)).astype(np.float32),
        None,
        specials,
        np.zeros((0, width), np.float32),
        rng.normal(size=(6, width)).astype(np.float32),  # exactly pad_len
        rng.normal(size=(1, width)),  # float64
    ]


@pytest.mark.parametrize("clean", [True, False])
@pytest.mark.parametrize("fill", [0.0, -1.5])
def test_pad_seq2d_matches_plain_and_jax_native(clean, fill):
    rows = _rows_2d(np.random.default_rng(2))
    tokens, mask = native.pad_seq2d(rows, 6, 4, fill, clean=clean)
    plain_tokens, plain_mask = native.pad_seq2d_plain(rows, 6, 4, fill, clean=clean)
    jax_tokens, jax_mask = jax_native.pad_seq2d(rows, 6, 4, fill, clean=clean)
    for want_tokens, want_mask in ((plain_tokens, plain_mask), (jax_tokens, jax_mask)):
        assert_bitwise(tokens, want_tokens)
        assert_bitwise(mask, want_mask)
    np.testing.assert_array_equal(mask.sum(1), [3, 6, 3, 6, 0, 5])
    if clean:
        fmax = np.finfo(np.float32).max
        assert tokens[2, 0, 1] == 0 and tokens[2, 1, 2] == fmax and tokens[2, 2, 0] == -fmax
    else:
        assert np.isnan(tokens[2, 0, 1]) and np.isinf(tokens[2, 1, 2])
    assert (tokens[1] == np.float32(fill)).all()


def _tcga_case():
    widths = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
    cfg = tiny_config("tcga", widths=widths)
    return cfg, make_tcga_like(10, widths=widths, p_missing=0.3, seed=3)


def _cmu_case():
    cfg = tiny_config("cmu")
    shapes = {m: (c["embedding_size"], c["pad_len"] + 3)  # some rows are cut
              for m, c in cfg["modality_config"].items()}
    rows = make_cmu_like(10, shapes=shapes, p_missing=0.3, seed=4)
    for r, v in zip(rows[:3], (np.nan, np.inf, -np.inf)):
        data = next(f["data"] for f in r.values() if f.get("data") is not None
                    and np.ndim(f["data"]) == 2)
        data[0, 0] = v
    return cfg, rows


@pytest.mark.parametrize("case", [_tcga_case, _cmu_case], ids=["tcga", "cmu"])
@pytest.mark.parametrize("jax_path", ["native", "numpy"])
def test_multimodal_collator_matches_jax(case, jax_path, monkeypatch):
    assert jax_native.available()
    cfg, rows = case()
    label_col = "Labels" if "Labels" in rows[0] else None
    got = MultimodalCollator(cfg["modality_config"], labels=label_col)(rows)
    if jax_path == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
    want = JaxCollator(cfg["modality_config"], labels=label_col)(rows)
    assert got.keys() == want.keys()
    for m in want:
        assert got[m].keys() == want[m].keys(), m
        for field in want[m]:
            assert_bitwise(got[m][field], want[m][field])


def test_over_long_row_with_truncate_false_raises_on_both_paths():
    """The JAX package's native path cuts this row to (2, 4, 3) without a
    word; its numpy path raises (could not broadcast (6,3) into (4,3))."""
    rows = [np.ones((2, 3), np.float32), np.ones((6, 3), np.float32)]
    coll = EmbeddedSequenceCollator(pad_len=4, embedding_size=3, truncate=False)
    with pytest.raises(ValueError, match="more than pad_len 4"):
        coll({"values": rows})
    for fn in (native.pad_seq2d, native.pad_seq2d_plain):
        with pytest.raises(ValueError, match="row 1 has 6 tokens"):
            fn(rows, 4, 3, 0.0)
    tokens = EmbeddedSequenceCollator(pad_len=4, embedding_size=3)({"values": rows})["tokens"]
    assert tokens.shape == (2, 4, 3)  # truncate: true cuts it


@pytest.mark.parametrize("bad", [np.ones((2, 2), np.float32), np.ones((2, 5), np.float32),
                                 np.ones((2,), np.float32)])
def test_row_of_the_wrong_width_raises_on_both_paths(bad):
    rows = [np.ones((3, 4), np.float32), bad]
    for fn in (native.pad_seq2d, native.pad_seq2d_plain):
        with pytest.raises(ValueError, match=r"row 1 has shape .*expected \[T, 4\]"):
            fn(rows, 6, 4, 0.0)
    with pytest.raises(ValueError, match="row 1 has shape"):
        EmbeddedSequenceCollator(pad_len=6, embedding_size=4)({"values": rows})


@pytest.mark.parametrize("how", ["failing compiler", "bad flag"])
def test_failed_build_raises_and_does_not_fall_back(how, tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    if how == "failing compiler":
        fake = tmp_path / "g++"
        fake.write_text("#!/bin/sh\necho 'fake compiler: no toolchain' >&2\nexit 1\n")
        fake.chmod(0o755)
        monkeypatch.setattr(native, "compiler_path", lambda: str(fake))
        message = "fake compiler: no toolchain"
    else:
        monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fno-such-flag",))
        message = "no-such-flag"
    with pytest.raises(RuntimeError, match=f"(?s)C\\+\\+ collate build failed.*{message}"):
        native.pad_rows([np.ones(3, np.float32)], 4, PAD)
    with pytest.raises(RuntimeError, match="C\\+\\+ collate build failed"):
        MultimodalCollator(tiny_config("tcga")["modality_config"])(_tcga_case()[1])
    assert not list((tmp_path / "build").glob("*.so"))
