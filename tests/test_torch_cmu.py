"""The CMU-MOSEI family in the port against the JAX package.

CMU_config1's four ``EmbeddedSequenceEncoder`` modalities at
``tests/test_cmu_family.py``'s tiny shapes (COVAREP 20 x 6, FACET 12 x 4,
OpenFace 12 x 8, glove_vectors 8 x 5: tokens x features; dim 32, depth
2, 2 heads x 16, 22 fusion tokens, T 74).  Rows come from each package's
``make_cmu_like`` (the same numpy draws), the weights from the JAX
model's ``init``, carried with ``state_dict_from_jax_params`` and loaded
with ``strict=True``.  The port runs on the CPU through the plain
versions of its kernels; the JAX side runs its flash kernels in
interpret mode for the MCA families (the attentive pool of a missing
modality reads dead rows, which flash leaves 0 and dense attention
fills) and its dense attention for EAO (mean pool), with the unfused
feed-forward in training, as its own tests do.

Covered: the generator, both new collators (bit for bit), narrowed
staging (bit for bit), the forward and one step of MCA, MMA/Zorro and
EAO, a 6-step MCA trajectory, two bf16-staged steps, serving, ``infer``'s
files, ``synthetic_rows`` and the training CLI.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mca_tpu import checkpoint as jax_checkpoint
from mca_tpu import infer as jax_infer
from mca_tpu import native as jax_native
from mca_tpu import serve as jax_serve
from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
import mca_tpu.data.collators  # noqa: F401  (mca_tpu.data re-exports a dict by that name)
from mca_tpu.data import synthetic as jax_synthetic
from mca_tpu.data.synthetic import tiny_config, to_hf_dataset
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.train import hf_lr_schedule as jax_hf_lr_schedule
from mca_tpu.train import init_state, make_optimizer, make_train_step
from mca_tpu.train import narrow_for_staging as jax_narrow
from mca_tpu.train import staging_sentinels as jax_sentinels
from mca_tpu_torch import checkpoint, infer
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.data import collators as port_collators
from mca_tpu_torch.data import synthetic as port_synthetic
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.models import EAO, MCA, build_model
from mca_tpu_torch.serve import EmbeddingService

jax_collators = sys.modules["mca_tpu.data.collators"]

torch.backends.cuda.matmul.allow_tf32 = False

SHAPES = {"COVAREP": (6, 20), "FACET": (4, 12), "OpenFace": (8, 12), "glove_vectors": (5, 8)}
EAO_KW = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
              fusion_combos=[2], fcl_root=[0, 1])
FAMILIES = {"mca": {}, "mma_zorro": dict(zorro=True), "eao": EAO_KW}
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(family="mca", side="port", **overrides):
    kw = FAMILIES[family]
    impl = "dense" if side == "jax" and kw.get("eao") else "pallas"
    return tiny_config("cmu", shapes=SHAPES, attention_impl=impl,
                       **{"precision": "fp32", **kw, **overrides})


def _rows(n=8, seed=1, p_missing=0.25):
    return jax_synthetic.make_cmu_like(n, shapes=SHAPES, p_missing=p_missing, seed=seed)


def _collate(cfg_dict, rows):
    return jax_collators.MultimodalCollator(jax_config(cfg_dict).modality_config.to_plain())(rows)


# -- data ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(n_samples=6, seed=3, p_missing=0.3),
                                dict(n_samples=3, shapes=SHAPES, latent_dim=4, seed=0)])
def test_make_cmu_like_matches_jax(kw):
    got, want = port_synthetic.make_cmu_like(**kw), jax_synthetic.make_cmu_like(**kw)
    assert len(got) == len(want)
    assert port_synthetic.CMU_MODALITIES == jax_synthetic.CMU_MODALITIES
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        for m in a:
            for f in a[m]:
                if b[m][f] is None:
                    assert a[m][f] is None, (m, f)
                else:
                    assert a[m][f].dtype == b[m][f].dtype
                    np.testing.assert_array_equal(a[m][f], b[m][f])
    assert any(r[m]["data"] is None for r in got for m in SHAPES) == (kw.get("p_missing", 0) > 0)


def _seq_rows(rng, n, width, pad_len):
    """Embedded-sequence rows: ragged, one longer than ``pad_len``, one
    missing, NaN and inf entries."""
    rows = [rng.normal(size=(int(rng.integers(1, pad_len)), width)).astype(np.float32)
            for _ in range(n)]
    rows[1] = rng.normal(size=(pad_len + 3, width)).astype(np.float32)  # truncated
    rows[2] = None
    rows[3][0, 1] = np.nan
    rows[3][-1, 0] = np.inf
    return rows


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize(
    "case",
    [
        dict(),
        dict(clean=False),
        dict(truncate=True, fill_value=-3.0),
        dict(all_missing=True),
        dict(first_missing=True),
    ],
    ids=["default", "no_clean", "fill", "all_missing", "first_missing"],
)
def test_embedded_sequence_collator_matches_jax(case, native, monkeypatch):
    """Bit for bit against the JAX package's numpy branch (and its C++
    fast path, which that package pins equal to the numpy one)."""
    if not native:
        monkeypatch.setattr(jax_native, "available", lambda: False)
    elif not jax_native.available():
        pytest.skip("the JAX package's native collate did not build here")
    case = dict(case)
    rng = np.random.default_rng(0)
    rows = _seq_rows(rng, 5, 4, 6)
    if case.pop("all_missing", False):
        rows = [None] * 4
    if case.pop("first_missing", False):
        rows[0] = None
    kw = dict(pad_len=6, embedding_size=4, data_col_name="data", **case)
    got = port_collators.EmbeddedSequenceCollator(**kw)({"data": rows})
    want = jax_collators.EmbeddedSequenceCollator(**kw)({"data": rows})
    assert got.keys() == want.keys() == {"tokens", "attention_mask"}
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])
    if not kw.get("clean", True):
        assert np.isnan(got["tokens"]).any()


@pytest.mark.parametrize("case", ["default", "max_channels", "all_missing", "first_missing"])
def test_matrix_collator_matches_jax(case):
    rng = np.random.default_rng(1)
    rows = [rng.normal(size=(int(t), 5)).astype(np.float32) for t in (3, 9, 2, 7)]
    rows[2] = None
    kw = dict(pad_len=7, pad_token=-10000)
    if case == "max_channels":
        kw["max_channels"] = 3
    if case == "all_missing":
        rows, kw["max_channels"] = [None, None], 4
    if case == "first_missing":
        rows[0] = None
    got = port_collators.MatrixCollator(**kw)({"values": rows})
    want = jax_collators.MatrixCollator(**kw)({"values": rows})
    assert got.keys() == want.keys() == {"values"}
    assert got["values"].dtype == want["values"].dtype and got["values"].shape == want["values"].shape
    np.testing.assert_array_equal(got["values"], want["values"])


def test_multimodal_collator_takes_every_type():
    """``sequence``, ``embedded_sequence`` and ``matrix`` modalities in
    one batch, with labels, as the JAX collator groups them."""
    rng = np.random.default_rng(2)
    mods = {
        "tab": {"type": "sequence", "pad_len": 5, "data_col_name": "values", "pad_token": -10000},
        "seq": {"type": "embedded_sequence", "pad_len": 6, "data_col_name": "data",
                "embedding_size": 3},
        "mat": {"type": "matrix", "pad_len": 4, "pad_token": -10000},
    }
    rows = [{"tab": {"values": rng.normal(size=int(rng.integers(2, 6))).astype(np.float32)},
             "seq": {"data": None if i == 1 else rng.normal(size=(i + 1, 3)).astype(np.float32)},
             "mat": None if i == 2 else {"values": rng.normal(size=(i + 2, 2)).astype(np.float32)},
             "Labels": {"data": rng.normal(size=7).astype(np.float32)}}
            for i in range(4)]
    got = port_collators.MultimodalCollator(mods, labels="Labels")(rows)
    want = jax_collators.MultimodalCollator(mods, labels="Labels")(rows)
    assert got.keys() == want.keys()
    for m in want:
        assert got[m].keys() == want[m].keys(), m
        for k in want[m]:
            assert got[m][k].dtype == want[m][k].dtype, (m, k)
            np.testing.assert_array_equal(got[m][k], want[m][k])


def test_synthetic_rows_follow_the_modality_types():
    cmu = training_config_from_dict(_cfg())
    rows = port_train.synthetic_rows(cmu, 5, seed=4)
    want = jax_synthetic.make_cmu_like(5, shapes=SHAPES, p_missing=0.25, seed=4)
    for a, b in zip(rows, want):
        for m in SHAPES:
            if b[m]["data"] is None:
                assert a[m]["data"] is None
            else:
                np.testing.assert_array_equal(a[m]["data"], b[m]["data"])
    tcga = training_config_from_dict(tiny_config("tcga"))
    assert set(port_train.synthetic_rows(tcga, 2)[0]) == {"gene", "protein", "methylation",
                                                          "mirna", "Labels"}
    mixed = training_config_from_dict(tiny_config("tcga"))
    mixed.modality_config["gene"]["type"] = "matrix"
    with pytest.raises(ValueError, match="matrix"):
        port_train.synthetic_rows(mixed, 2)


# -- narrowed staging ---------------------------------------------------


def _dtype_name(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _as_f32(x):
    """A staged column as float32 / int numpy (ml_dtypes and torch alike)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.kind == "V" or "bfloat16" in str(x.dtype) else x


STAGING_CASES = {
    # TCGA's sentinel -1.0: exact in fp16 and bf16; live values at -1 +-
    # a few bf16 units collide with it and are moved toward zero
    "tabular": ({"m": {"type": "sequence", "pad_len": 6}},
                {"m": {"type": "TabularEncoder", "num_embeddings": 6}}),
    # -10000: exact in fp16 (live values within 4 of it collide), not in
    # bf16 (the modality stays fp32)
    "matrix": ({"m": {"type": "matrix", "pad_len": 6, "pad_token": -10000}},
               {"m": {"type": "PatchEncoder"}}),
    # no sentinel: narrows freely, the bool mask passes
    "embedded_sequence": ({"m": {"type": "embedded_sequence", "pad_len": 6}},
                          {"m": {"type": "EmbeddedSequenceEncoder", "input_size": 3}}),
    "sparse": ({"m": {"type": "sequence", "pad_len": 6}},
               {"m": {"type": "SparseTabularEncoder"}}),
}


def _staging_batch(kind):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 6)).astype(np.float32)
    if kind == "embedded_sequence":
        return {"m": {"tokens": rng.normal(size=(4, 6, 3)).astype(np.float32) * 1e3,
                      "attention_mask": rng.random((4, 6)) < 0.3}}
    pad = {"tabular": -1.0, "matrix": -10000.0, "sparse": 0.0}[kind]
    x[0, :2] = pad  # real sentinels
    x[1, :3] = [pad * 1.0001, pad * 0.9999, pad * 1.003]  # live values beside it
    x[2, 0] = 1e-45 if pad == 0 else pad  # rounds onto the zero sentinel
    return {"m": {"values": x, "attention_mask": (x == pad).astype(np.int64),
                  "indices": np.arange(24, dtype=np.int64).reshape(4, 6)}}


@pytest.mark.parametrize("stage", ["fp16", "bf16"])
@pytest.mark.parametrize("kind", sorted(STAGING_CASES))
def test_narrow_for_staging_matches_jax(kind, stage):
    mods, encs = STAGING_CASES[kind]
    cfg_dict = {"modality_config": mods, "encoder_configs": encs}
    sent = port_train.staging_sentinels(training_config_from_dict(cfg_dict))
    assert sent == jax_sentinels(jax_config(cfg_dict))
    batch = _staging_batch(kind)
    if kind == "sparse" and stage == "bf16":
        # the JAX package cannot take this case (np.finfo refuses
        # ml_dtypes' bfloat16 when it looks for the value next to 0); the
        # port moves the collided live value to bf16's smallest normal
        with pytest.raises(ValueError, match="inexact"):
            jax_narrow(batch, stage, sent)
        got = port_train.narrow_for_staging(batch, stage, sent)["m"]["values"]
        want = torch.from_numpy(batch["m"]["values"]).to(torch.bfloat16)
        want[2, 0] = torch.finfo(torch.bfloat16).smallest_normal
        assert float(torch.from_numpy(batch["m"]["values"])[2, 0].to(torch.bfloat16)) == 0.0
        assert torch.equal(got, want)
        return
    for sentinels in (sent, None):
        got = port_train.narrow_for_staging(batch, stage, sentinels)
        want = jax_narrow(batch, stage, sentinels)
        assert got["m"].keys() == want["m"].keys()
        for k, w in want["m"].items():
            g = got["m"][k]
            assert _dtype_name(g) == _dtype_name(np.asarray(w)), k
            np.testing.assert_array_equal(_as_f32(g), _as_f32(w), err_msg=k)
    if kind == "matrix" and stage == "bf16":
        assert port_train.narrow_for_staging(batch, stage, sent)["m"]["values"] is batch["m"]["values"]
    assert port_train.narrow_for_staging(batch, "fp32", sent) is batch


def test_to_device_restores_fp32():
    batch = _staging_batch("tabular")
    staged = port_train.narrow_for_staging(batch, "bf16", {"m": -1.0})
    assert staged["m"]["values"].dtype == torch.bfloat16
    assert staged["m"]["indices"].dtype == torch.int32
    dev = port_train.to_device(staged, "cpu")
    assert dev["m"]["values"].dtype == torch.float32
    np.testing.assert_array_equal(dev["m"]["values"].numpy(), _as_f32(staged["m"]["values"]))


# -- models ---------------------------------------------------------------


def _jax_run(family, precision="fp32"):
    d = _cfg(family, side="jax", precision=precision)
    batch_np = _collate(d, _rows())
    jmodel = jax_build_model(jax_model_config(jax_config(d)))
    batch_j = jax.tree.map(jnp.asarray, batch_np)
    params = jax.jit(jmodel.init)(jax.random.key(0), batch_j)

    def loss(p, b):
        out = jmodel.apply(p, b)
        return out["loss"], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch_j)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, jout), float(jloss),
            state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads)), batch_np)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")

        def get(family, precision="fp32"):
            if (family, precision) not in cache:
                cache[family, precision] = _jax_run(family, precision)
            return cache[family, precision]

        yield get


def _port(jax_runs, family, precision="fp32"):
    params, jout, jloss, jgrads, batch_np = jax_runs(family, precision)
    cfg = training_config_from_dict(_cfg(family, precision=precision))
    model = build_model(get_model_config(cfg), fused_ff=False)
    model.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return model, port_train.to_device(batch_np, "cpu"), jout, jloss, jgrads


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_matches_jax(jax_runs, family):
    model, batch, jout, _, _ = _port(jax_runs, family)
    model.eval()
    with torch.inference_mode():
        out = model(batch)
    keys = sorted(k for k in jout if k not in ("losses", "modality_sample_mask"))
    assert keys == sorted(k for k in out if k not in ("losses", "modality_sample_mask"))
    for k in keys:  # fp32 both sides, sums in another order
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in jout["losses"].items():  # some pair losses are ~0: an absolute floor
        np.testing.assert_allclose(float(out["losses"][k]), float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for m, present in jout["modality_sample_mask"].items():
        np.testing.assert_array_equal(out["modality_sample_mask"][m].numpy(), present)
    assert not all(jout["modality_sample_mask"][m].all() for m in SHAPES)  # one is missing
    assert isinstance(model, EAO if family == "eao" else MCA)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_one_step_matches_jax(jax_runs, family):
    model, batch, _, jloss, jgrads = _port(jax_runs, family)
    model.train()
    scal = port_train.forward_backward(model, batch)
    names = sorted(jgrads)
    got = torch.cat([dict(model.named_parameters())[n].grad.reshape(-1) for n in names])
    want = torch.cat([jgrads[n].reshape(-1) for n in names])
    np.testing.assert_allclose(float(scal["total_loss"]), jloss, rtol=1e-4)
    rel = float((got - want).norm() / want.norm())
    assert rel <= 1e-4, rel
    enc_names = [n for n in names if n.startswith("encoders.") and jgrads[n].abs().sum() > 0]
    assert any(".token_encoder.1." in n for n in enc_names)  # the projection trains


def test_bf16_forward_and_step_match_jax(jax_runs):
    """bf16 compute on both sides: both round activations to 8
    significant bits, at different places: 2e-2."""
    model, batch, jout, jloss, jgrads = _port(jax_runs, "mca", "bf16")
    model.train()
    scal = port_train.forward_backward(model, batch)
    np.testing.assert_allclose(float(scal["total_loss"]), jloss, rtol=2e-2)
    names = sorted(jgrads)
    got = torch.cat([dict(model.named_parameters())[n].grad.reshape(-1) for n in names])
    want = torch.cat([jgrads[n].reshape(-1) for n in names])
    assert float((got - want).norm() / want.norm()) <= 2e-2
    model.eval()
    with torch.inference_mode():
        out = model(batch)
    for k in ("fusion", "COVAREP", "combo:0,1"):
        rel = np.linalg.norm(out[k].float().numpy() - jout[k]) / np.linalg.norm(jout[k])
        assert rel <= 2e-2, (k, rel)


def _jax_trajectory(monkeypatch, cfg_dict, batches, stage_dtype="fp32"):
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    jcfg = jax_config(cfg_dict)
    jmodel = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = jax_hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS)
    sentinels = jax_sentinels(jcfg)
    bj = [jax.tree.map(jnp.asarray, jax_narrow(b, stage_dtype, sentinels)) for b in batches]
    state = init_state(jmodel, tx, jax.tree.map(jnp.asarray, batches[0]), seed=0)
    params0 = jax.tree.map(np.asarray, state["params"])
    step = make_train_step(jmodel, tx, schedule)
    history = []
    for i in range(len(batches) if stage_dtype != "fp32" else STEPS):
        state, metrics = step(state, bj[i % len(bj)])
        history.append({k: float(v) for k, v in metrics.items()})
    return params0, history


def _port_trajectory(cfg_dict, params0, batches, n_steps, stage_dtype="fp32"):
    cfg = training_config_from_dict(cfg_dict)
    model, opt, sched = port_train.build_trainer(
        cfg, "cpu", num_training_steps=STEPS, params=state_dict_from_jax_params(params0))
    sentinels = port_train.staging_sentinels(cfg)
    return [
        port_train.train_step(
            model, opt, sched,
            port_train.to_device(port_train.narrow_for_staging(
                batches[i % len(batches)], stage_dtype, sentinels), "cpu"),
            clip=cfg.clip, dropout_seed=int(cfg.seed))
        for i in range(n_steps)
    ]


def _assert_histories(phist, jhist, rtol):
    assert len(phist) == len(jhist) and set(phist[0]) == set(jhist[0])
    for i, (p, j) in enumerate(zip(phist, jhist)):
        for k, v in j.items():
            if np.isnan(v):
                assert np.isnan(p[k]), (i, k)
            else:
                np.testing.assert_allclose(p[k], v, rtol=rtol, atol=1e-7, err_msg=f"step {i} {k}")


def test_six_step_trajectory_matches_jax(monkeypatch):
    """fp32, the same arithmetic in another order through AdamW's
    normalised updates: 1e-4 over 6 steps."""
    cfg_dict = _cfg()
    rows = _rows(seed=0)
    batches = [_collate(cfg_dict, rows[i : i + 4]) for i in (0, 4)]
    params0, jhist = _jax_trajectory(monkeypatch, cfg_dict, batches)
    phist = _port_trajectory(cfg_dict, params0, batches, STEPS)
    _assert_histories(phist, jhist, 1e-4)
    assert phist[-1]["total_loss"] < phist[0]["total_loss"]


def test_bf16_staged_steps_match_jax(monkeypatch):
    """Two steps on batches staged as ``stage_dtype: bf16`` stages them,
    each package narrowing its own copy: 1e-4 (fp32 compute)."""
    cfg_dict = _cfg(stage_dtype="bf16")
    rows = _rows(seed=2)
    batches = [_collate(cfg_dict, rows[i : i + 4]) for i in (0, 4)]
    params0, jhist = _jax_trajectory(monkeypatch, cfg_dict, batches, "bf16")
    phist = _port_trajectory(cfg_dict, params0, batches, 2, "bf16")
    _assert_histories(phist, jhist, 1e-4)
    fp32 = _port_trajectory(cfg_dict, params0, batches, 2)
    assert fp32[1]["total_loss"] != phist[1]["total_loss"]  # the narrowing did round


# -- serving, infer, CLI ------------------------------------------------


def test_zero_row_templates_match_jax():
    mods = {
        "seq": {"type": "embedded_sequence", "pad_len": 6, "data_col_name": "data",
                "embedding_size": 3, "pad_token": -10000},
        "in": {"type": "embedded_sequence", "pad_len": 4, "input_size": 5},
        "mat": {"type": "matrix", "pad_len": 4, "width": 2, "pad_token": -7},
        "bare": {"type": "matrix", "pad_len": 3},
        "tab": {"type": "sequence", "pad_len": 5, "pad_token": -10000},
    }
    got = EmbeddingService._zero_row(mods)
    want = jax_serve.EmbeddingService._zero_row(None, mods)
    assert got.keys() == want.keys()
    for m in want:
        assert got[m].keys() == want[m].keys()
        for f in want[m]:
            assert got[m][f].dtype == want[m][f].dtype
            np.testing.assert_array_equal(got[m][f], want[m][f])
    assert got["seq"]["data"].shape == (6, 3) and not got["seq"]["data"].any()
    assert (got["mat"]["values"] == -7).all() and got["bare"]["values"].shape == (3, 1)


def test_service_embeds_cmu_rows_as_jax_does(monkeypatch):
    monkeypatch.setenv("MCA_FUSED_FF", "auto")
    d = _cfg(batch_size=4)
    rows = [{m: r[m] for m in SHAPES} for r in _rows(6, seed=3)]
    jcfg = jax_config(d)
    jmodel = jax_build_model(jax_model_config(jcfg))
    batch = jax.tree.map(jnp.asarray, _collate(d, rows[:4]))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0), batch))
    jsvc = jax_serve.EmbeddingService(jcfg, params=params, max_batch=4, warmup=False)
    svc = EmbeddingService(training_config_from_dict(d), params=state_dict_from_jax_params(params),
                           max_batch=4, device="cpu", warmup=True)
    want, got = jsvc.embed(rows), svc.embed(rows)  # 6 rows: chunks of 4 and 2
    assert sorted(got["embeddings"]) == sorted(want["embeddings"])
    for k, w in want["embeddings"].items():
        np.testing.assert_allclose(got["embeddings"][k], np.asarray(w), rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    for k, w in want["present"].items():
        np.testing.assert_array_equal(got["present"][k], np.asarray(w))
    assert not all(got["present"][k].all() for k in got["present"])


@pytest.fixture(scope="module")
def cmu_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cmu")
    to_hf_dataset(_rows(24, seed=0, p_missing=0.2)).save_to_disk(str(root / "ds"))
    return root


def test_infer_files_match_jax(cmu_dataset, monkeypatch):
    """24 rows, split 0.25, batch 4: 4 train and 1 eval batch.  Keys,
    masks and the 7 float labels exact; fp32 embeddings 1e-4."""
    root = cmu_dataset
    d = _cfg(batch_size=4, split=0.25, dataset=str(root / "ds"))
    jcfg = jax_config(d)
    jmodel = jax_build_model(jax_model_config(jcfg))
    batch = jax.tree.map(jnp.asarray, _collate(d, [{**r} for r in _rows(4, seed=5)]))
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.key(0), batch))
    jax_checkpoint.save_params(params, str(root / "jax_model"))
    checkpoint.save_params(state_dict_from_jax_params(params), str(root / "port_model"))
    monkeypatch.setenv("MCA_FUSED_FF", "auto")
    jcfg.restart, jcfg.output_dir = str(root / "jax_model"), str(root / "jax_out")
    jax_infer.infer(jcfg)
    cfg = training_config_from_dict(d)
    cfg.restart, cfg.output_dir = str(root / "port_model"), str(root / "port_out")
    infer.infer(cfg, device="cpu")
    for split, n in (("train", 16), ("eval", 4)):
        stem = f"{split}_"
        labels = infer.load_label_file(str(root / "port_out" / (stem + "labels")))
        np.testing.assert_array_equal(
            labels, jax_infer.load_label_file(str(root / "jax_out" / (stem + "labels"))))
        assert labels.shape == (n, 7) and labels.dtype == np.float32
        for kind in ("masks", "embeddings"):
            got = infer.load_embedding_file(str(root / "port_out" / (stem + kind)))
            want = jax_infer.load_embedding_file(str(root / "jax_out" / (stem + kind)))
            assert sorted(got, key=str) == sorted(want, key=str), kind
            for k, w in want.items():
                if kind == "masks":
                    np.testing.assert_array_equal(got[k], w)
                else:
                    np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5, err_msg=str(k))
                    assert got[k].shape == (n, 32)


def test_cli_trains_a_cmu_config_on_synthetic_rows(tmp_path):
    cfg_path = tmp_path / "cmu.yaml"
    out = tmp_path / "out"
    # 16 rows, split 0.25: 12 train rows (3 batches of 4 an epoch), 1 eval batch
    cfg_path.write_text(yaml.safe_dump({**_cfg(stage_dtype="bf16"), "epochs": 2,
                                        "output_dir": str(out)}))
    port_train.main([str(cfg_path), "--synthetic", "16", "--device", "cpu"])
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [m for m in lines if "total_loss" in m]
    assert [m["step"] for m in steps] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(m["total_loss"]) for m in steps)
    assert any("val_epoch_total_loss" in m for m in lines)
    assert os.path.isdir(out / "model")


def test_profiling_helpers_follow_the_config():
    """``tools.request_rows`` makes rows of the config's own shape (CMU
    rows without labels), ``tools.host_batch_costs`` counts the bytes a
    batch copies at each staging (bf16 about half of fp32 for CMU, whose
    masks stay bool), ``tools.sample_tokens`` the tokens a sample puts
    through the blocks (EAO: the sum of its ten passes)."""
    from mca_tpu_torch import tools
    from mca_tpu_torch.data.synthetic import tabular_rows

    cmu = training_config_from_dict(_cfg())
    rows = tools.request_rows(cmu, 3)
    assert [set(r) for r in rows] == [set(SHAPES)] * 3
    want = port_train.synthetic_rows(cmu, 3, seed=1)
    for r, w in zip(rows, want):
        for m in SHAPES:
            assert (r[m]["data"] is None) == (w[m]["data"] is None)
    tcga = training_config_from_dict(tiny_config("tcga"))
    np.testing.assert_array_equal(tools.request_rows(tcga, 2)[1]["gene"]["values"],
                                  tabular_rows(tcga.modality_config.to_plain(), 2)[1]["gene"]["values"])
    costs = tools.host_batch_costs(cmu, rows, "cpu", repeats=1)
    n_tok = sum(3 * t * d for d, t in SHAPES.values())
    n_mask = sum(3 * t for _, t in SHAPES.values())
    assert costs["fp32"]["bytes"] == 4 * n_tok + n_mask
    assert costs["bf16"]["bytes"] == 2 * n_tok + n_mask
    assert all(costs[k] >= 0 for k in ("collate_ms",))
    model = build_model(get_model_config(cmu))
    assert tools.sample_tokens(cmu, model) == model.mask_set.seq_len == 20 + 12 + 12 + 8 + 22
    eao = training_config_from_dict(_cfg("eao"))
    lens = [t for _, t in SHAPES.values()]
    want_eao = sum(lens) + sum(a + b for i, a in enumerate(lens) for b in lens[i + 1:])
    assert tools.sample_tokens(eao, build_model(get_model_config(eao))) == want_eao
