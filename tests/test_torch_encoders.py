"""The port's five modality encoders against the JAX package's.

Each encoder is initialised in JAX, its parameters perturbed with seeded
numpy noise (so no LayerNorm is the identity and no bias is zero),
carried into the port with ``state_dict_from_jax_params`` and loaded
with ``strict=True``; both run the same numpy batch.  fp32 on both sides
with sums in another order: 1e-5.  Also the kwargs rules of
``build_encoder`` and the semantics of the encoders' dropout, which
draws from a ``torch.Generator`` the caller hands it (the bits cannot
equal JAX's threefry, so the parity tests run without dropout).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu import encoders as jax_enc
from mca_tpu_torch import encoders as port_enc
from mca_tpu_torch import train as port_train
from mca_tpu_torch.interop import state_dict_from_jax_params

torch.backends.cuda.matmul.allow_tf32 = False

DIM = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(kind: str, rng):
    """A numpy batch for encoder ``kind`` with padding in it."""
    if kind == "tabular":
        values = rng.normal(size=(3, 10)).astype(np.float32)
        values[0, 6:] = -10000.0  # ragged tail (the collator's pad)
        values[1, 2] = -1.0  # the value encoder's padding value
        return {"values": values, "attention_mask": (values == -10000.0).astype(np.int64)}
    if kind == "sparse_tabular":
        idx = rng.integers(1, 20, size=(3, 7)).astype(np.int64)
        data = rng.normal(size=(3, 7)).astype(np.float32)
        idx[0, 5:], data[0, 5:] = 0, 0.0
        return {"indices": idx, "data": data, "attention_mask": (idx == 0).astype(np.int64)}
    if kind == "sequence":
        tokens = rng.integers(1, 12, size=(3, 6)).astype(np.int64)
        tokens[1, 4:] = 0
        return {"tokens": tokens, "attention_mask": (tokens == 0).astype(np.int64)}
    if kind == "embedded_sequence":
        tokens = rng.normal(size=(3, 9, 5)).astype(np.float32)
        mask = np.zeros((3, 9), bool)
        mask[0, 4:] = True
        mask[2] = True  # a missing modality
        tokens[mask] = 0.0
        return {"tokens": tokens, "attention_mask": mask}
    mode = kind.split("_")[1]
    shape = {"matrix": (2, 8, 6), "image": (2, 3, 8, 8), "video": (2, 3, 4, 8, 8)}[mode]
    values = rng.normal(size=shape).astype(np.float32)
    if mode == "matrix":
        values[0, 4:] = -10000.0  # the bottom half all pad: 4 of 8 patches
    return {"values": values}


CASES = {
    "tabular": ("TabularEncoder", dict(num_embeddings=10, max_value=100.0)),
    "sparse_tabular": ("SparseTabularEncoder", dict(num_embeddings=20)),
    "sequence": ("SequenceEncoder", dict(num_embeddings=12, max_tokens=6)),
    "embedded_sequence": ("EmbeddedSequenceEncoder", dict(input_size=5, max_tokens=9)),
    "patch_matrix": ("PatchEncoder", dict(patch_size=(2, 3), mode="matrix", max_tokens=8,
                                          dropout=0.0)),
    "patch_image": ("PatchEncoder", dict(patch_size=(4, 4), mode="image", num_channels=3,
                                         max_tokens=4, dropout=0.0)),
    "patch_video": ("PatchEncoder", dict(patch_size=(2, 4, 4), mode="video", num_channels=3,
                                         max_tokens=8, dropout=0.0)),
}


def _pair(kind: str, seed: int = 0):
    """(JAX module, its perturbed params, the port's encoder with them
    loaded strictly, the numpy batch)."""
    etype, kw = CASES[kind]
    rng = np.random.default_rng(seed)
    batch = _batch(kind, rng)
    jmod = getattr(jax_enc, etype)(embedding_dim=DIM, **kw)
    params = jmod.init(jax.random.key(seed), jax.tree.map(jnp.asarray, batch))
    params = jax.tree.map(
        lambda a: np.asarray(a) + 0.3 * rng.normal(size=a.shape).astype(np.float32), params)
    sd = state_dict_from_jax_params({"params": {"x": params["params"]}})
    port = getattr(port_enc, etype)(embedding_dim=DIM, **kw)
    port.load_state_dict({k.removeprefix("encoders.x."): v for k, v in sd.items()}, strict=True)
    return jmod, params, port.eval(), batch


def _run_both(jmod, params, port, batch):
    jt, jm = jmod.apply(params, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        pt, pm = port({k: torch.from_numpy(v) for k, v in batch.items()})
    return (np.asarray(jt), None if jm is None else np.asarray(jm)), (
        pt.numpy(), None if pm is None else pm.numpy())


@pytest.mark.parametrize("kind", sorted(CASES))
def test_encoder_matches_jax(kind):
    jmod, params, port, batch = _pair(kind)
    (jt, jm), (pt, pm) = _run_both(jmod, params, port, batch)
    assert pt.shape == jt.shape and pt.dtype == np.float32
    np.testing.assert_allclose(pt, jt, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(pm, jm)
    if kind == "patch_matrix":
        assert pm.dtype == np.int64 and pm[0].sum() == 4 and pm[1].sum() == 0


@pytest.mark.parametrize("kind", ["embedded_sequence", "tabular"])
def test_encoder_matches_jax_on_bf16_staged_inputs(kind):
    """The bf16 case: float inputs as ``stage_dtype: bf16`` stages them
    (narrowed on the host, fp32 again on the device), through both."""
    jmod, params, port, batch = _pair(kind, seed=3)
    staged = port_train.narrow_for_staging({"m": batch}, "bf16", {"m": None})["m"]
    batch16 = {k: torch.as_tensor(v).float().numpy() if torch.as_tensor(v).is_floating_point()
               else np.asarray(torch.as_tensor(v)) for k, v in staged.items()}
    assert any(not np.array_equal(batch16[k], batch[k]) for k in batch)  # it did round
    (jt, _), (pt, _) = _run_both(jmod, params, port, batch16)
    np.testing.assert_allclose(pt, jt, rtol=1e-5, atol=1e-5)


def test_padding_idx_wraps_like_torch():
    """``padding_idx=-1`` is the last row of the table: it looks up a
    zero vector, in both packages."""
    enc = port_enc.TokenEncoder(6, DIM, padding_idx=-1)
    jmod = jax_enc.TokenEncoder(6, DIM, padding_idx=-1)
    idx = np.array([[0, 5, 2], [5, 1, 3]])
    params = jmod.init(jax.random.key(0), jnp.asarray(idx))
    with torch.no_grad():
        enc.embedding.weight.copy_(torch.from_numpy(np.array(params["params"]["embedding"])))
        got = enc(torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmod.apply(params, jnp.asarray(idx))),
                               rtol=1e-6, atol=1e-7)
    assert not got[0, 1].any() and not got[1, 0].any() and got[0, 0].any()


def test_embedded_sequence_pads_carry_pure_positional_encoding():
    """Padded rows are zeroed before and after the norms: whatever they
    held (NaN included), they come out as the sinusoidal table alone."""
    _, _, port, batch = _pair("embedded_sequence")
    batch["tokens"][0, 6] = np.nan
    with torch.no_grad():
        tokens, _ = port({k: torch.from_numpy(v) for k, v in batch.items()})
    pe = port.positional_encoder.pe[:9].numpy()
    np.testing.assert_array_equal(tokens[0, 4:].numpy(), pe[4:])
    np.testing.assert_array_equal(tokens[2].numpy(), pe)
    assert np.isfinite(tokens.numpy()).all()
    assert not np.allclose(tokens[0, :4].numpy(), pe[:4])


def test_positional_table_matches_jax():
    jpe = jax_enc.PositionalEncoder(d_model=DIM, max_len=16)
    want = np.asarray(jpe.apply(jpe.init(jax.random.key(0), 5), 5, True, 3))
    got = port_enc.PositionalEncoder(DIM, dropout=0.0, max_len=16).eval()(5, 3).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0, 0, 0] == 0.0 and got[0, 0, 1] == 1.0


@pytest.mark.parametrize(
    "etype,cfg,want",
    [
        # max_tokens reaches only the three encoders that take it, with
        # 1024 where the config has none; collator keys never do
        ("TabularEncoder", {"num_embeddings": 8, "max_tokens": 8, "dropout_collator": 0.3}, {}),
        ("SequenceEncoder", {"num_embeddings": 8}, {"max_tokens": 1024}),
        ("EmbeddedSequenceEncoder", {"input_size": 4, "max_tokens": 50, "pad_len": 50},
         {"max_tokens": 50}),
        ("PatchEncoder", {"patch_size": [2, 2], "max_tokens": 4, "embedding_dim": 12},
         {"max_tokens": 4, "embedding_dim": 12}),
        ("SparseTabularEncoder", {"num_embeddings": 30, "max_tokens": 5}, {}),
    ],
)
def test_build_encoder_kwargs(etype, cfg, want, monkeypatch):
    seen = {}
    cls = port_enc.encoders_dict[etype]

    class Spy(cls):
        @functools.wraps(cls.__init__)  # build_encoder reads the signature
        def __init__(self, **kw):
            seen.update(kw)
            super().__init__(**kw)

    monkeypatch.setitem(port_enc.encoders_dict, etype, Spy)
    enc = port_enc.build_encoder("m", {"type": etype, **cfg}, embedding_dim=DIM)
    assert isinstance(enc, cls)
    assert seen.get("embedding_dim") == want.get("embedding_dim", DIM)
    assert ("max_tokens" in seen) == ("max_tokens" in want)
    if "max_tokens" in want:
        assert seen["max_tokens"] == want["max_tokens"]
    assert not {"type", "dropout_collator", "pad_len"} & set(seen)
    # the JAX package builds the same module from the same entry
    jax_enc.build_encoder("m", {"type": etype, **cfg}, embedding_dim=DIM)


def test_build_encoder_refuses_an_unknown_type():
    with pytest.raises(ValueError, match="Nope"):
        port_enc.build_encoder("m", {"type": "NopeEncoder"}, DIM)
    with pytest.raises(ValueError, match="num_channels"):
        port_enc.build_encoder("m", {"type": "PatchEncoder", "mode": "image",
                                     "patch_size": [2, 2]}, DIM)


def _pe(rate=0.5, d=64, max_len=32):
    return port_enc.PositionalEncoder(d, dropout=rate, max_len=max_len)


def test_positional_dropout_masks_differ_per_sample():
    out = _pe().train()(16, 4, torch.Generator().manual_seed(0))
    dropped = out == 0
    for i in range(1, 4):
        assert not torch.equal(dropped[0], dropped[i]), i


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_rate_and_rescale(rate):
    """The dropped share is within 5 standard deviations of the binomial
    around ``rate``; kept entries are scaled by ``1 / (1 - rate)``."""
    x = torch.ones((8, 32, 64))
    out = port_enc.dropout(x, rate, torch.Generator().manual_seed(1))
    n = x.numel()
    share = float((out == 0).float().mean())
    assert abs(share - rate) <= 5 * (rate * (1 - rate) / n) ** 0.5, share
    kept = out[out != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / (1 - rate)))


def test_dropout_generator_follows_seed_step_and_microbatch():
    pe = _pe().train()

    def mask(seed, step, micro):
        return pe(16, 2, port_train.dropout_generator(seed, step, micro, "cpu")) == 0

    same = mask(43, 7, None)
    assert torch.equal(same, mask(43, 7, None))
    for other in ((43, 8, None), (44, 7, None), (43, 7, 0), (43, 7, 1)):
        assert not torch.equal(same, mask(*other)), other
    assert torch.equal(mask(43, 7, 1), mask(43, 7, 1))


@pytest.mark.parametrize("kind", ["pe", "patch"])
def test_eval_mode_equals_dropout_off(kind):
    if kind == "pe":
        live, off = _pe(0.5), _pe(0.0)
        args = (16, 3)
    else:
        rng = np.random.default_rng(0)
        live = port_enc.PatchEncoder((2, 3), "matrix", embedding_dim=DIM, max_tokens=8,
                                     dropout=0.5)
        off = port_enc.PatchEncoder((2, 3), "matrix", embedding_dim=DIM, max_tokens=8,
                                    dropout=0.0)
        off.load_state_dict(live.state_dict(), strict=True)
        args = ({"values": torch.from_numpy(rng.normal(size=(2, 8, 6)).astype(np.float32))},)
    with torch.no_grad():
        want = off.train()(*args)
        got = live.eval()(*args)  # draws nothing: no generator needed
        trained = live.train()(*args, generator=torch.Generator().manual_seed(0))
    first = (lambda o: o[0]) if kind == "patch" else (lambda o: o)
    torch.testing.assert_close(first(got), first(want), rtol=0, atol=0)
    assert not torch.equal(first(trained), first(want))


def test_train_mode_dropout_refuses_the_global_rng():
    with pytest.raises(ValueError, match="Generator"):
        _pe().train()(8, 2)
    _pe(0.0).train()(8, 2)  # no dropout: nothing to draw
