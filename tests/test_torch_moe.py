"""The port's mixture-of-experts feed-forward (``mca_tpu_torch.models.moe``)
and ``tools/moe_stats`` against the JAX package's.

Inputs are made with numpy from a seed; JAX parameters are carried into
the port with ``state_dict_from_jax_params`` and loaded with
``strict=True``.  The module is held in fp32 at 1e-5 (values and the
gradients of x, the router and both expert matrices) against both arms
of the JAX module (``MCA_MOE_IMPL``: one-hot products and gather /
scatter-add; the port keeps the gather), with and without padding, for 1, 2 and 4 experts;
the routing's token choice bit for bit, ties included.  The tiny MCA
model (``tiny_config("tcga", attention_impl="pallas")``, the JAX flash
kernels in interpret mode) with ``moe_experts: 2`` is held in its
forward and one step's loss and gradient at 1e-4, the EAO variant in its
forward.
"""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config, to_hf_dataset
from mca_tpu.interop import export_state_dict as jax_export_state_dict
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.models.moe import MoEFeedForward as JaxMoE
from mca_tpu.models.moe import expert_capacity as jax_expert_capacity
from mca_tpu.tools.moe_stats import extract_moe_stats as jax_extract_moe_stats
from mca_tpu.tools.moe_stats import routing_stats as jax_routing_stats
from mca_tpu_torch import checkpoint
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.models import FeedForward, MCALayer, build_model
from mca_tpu_torch.models.moe import MoEFeedForward, expert_capacity
from mca_tpu_torch.serve import EmbeddingService
from mca_tpu_torch.tools.moe_stats import extract_moe_stats, routing_stats

torch.backends.cuda.matmul.allow_tf32 = False

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
EAO_KW = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
              fusion_combos=[2], fcl_root=[0, 1])
B, T, D = 2, 10, 12


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores, where per-worker thread pools
    oversubscribe them and slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_expert_capacity_matches_jax():
    for seq_len in (1, 7, 12, 58, 2548):
        for experts in (1, 2, 3, 4, 8):
            for cf in (0.01, 0.5, 1.0, 1.25, 2.0, 9.0):
                assert expert_capacity(seq_len, experts, cf) == jax_expert_capacity(
                    seq_len, experts, cf), (seq_len, experts, cf)
    assert expert_capacity(2548, 2, 2.0) == 2548 and expert_capacity(2548, 4, 1.0) == 637


def _module_pair(experts, cf, seed=0):
    """A JAX module with its parameters and the port's module with the
    same parameters."""
    x = np.random.default_rng(seed).normal(size=(B, T, D)).astype(np.float32)
    jmod = JaxMoE(dim=D, num_experts=experts, mult=4, capacity_factor=cf)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(seed), jnp.asarray(x))["params"])
    pmod = MoEFeedForward(D, experts, mult=4, capacity_factor=cf)
    pmod.load_state_dict({"router.weight": torch.tensor(params["router"]),
                          "experts.w_in": torch.tensor(params["w_in"]),
                          "experts.w_out": torch.tensor(params["w_out"])}, strict=True)
    return jmod, params, pmod, x


def _padding(with_padding):
    if not with_padding:
        return None
    pad = np.zeros((B, T), bool)
    pad[0, 7:] = True
    pad[1, 3:] = True  # fewer real tokens than an expert's capacity
    return pad


@pytest.mark.parametrize("impl", ["onehot", "gather"])
@pytest.mark.parametrize("with_padding", [False, True])
@pytest.mark.parametrize("experts", [1, 2, 4])
def test_module_values_and_gradients_match_jax(experts, with_padding, impl, monkeypatch):
    monkeypatch.setenv("MCA_MOE_IMPL", impl)  # the JAX module's arm
    jmod, params, pmod, x = _module_pair(experts, 1.5)
    pad = _padding(with_padding)
    w = np.random.default_rng(1).normal(size=(B, T, D)).astype(np.float32)
    jpad = None if pad is None else jnp.asarray(pad)

    def loss(p, xx):
        return (jmod.apply({"params": p}, xx, jpad) * w).sum()

    jy = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jpad))
    jgp, jgx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    y = pmod(xt, None if pad is None else torch.tensor(pad))
    (y * torch.tensor(w)).sum().backward()
    # fp32 both sides, products summed in another order
    np.testing.assert_allclose(y.detach().numpy(), jy, rtol=1e-5, atol=1e-6)
    got = {"x": xt.grad, "router": pmod.router["weight"].grad,
           "w_in": pmod.experts["w_in"].grad, "w_out": pmod.experts["w_out"].grad}
    want = {"x": jgx, **jgp}
    for k, v in want.items():
        v = np.asarray(v)
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(v).max()), err_msg=k)
    # the gates carry a gradient, except through a softmax over one expert
    assert (float(np.abs(np.asarray(jgp["router"])).max()) > 0) == (experts > 1)


def _recorded(pmod, x, pad):
    pmod.record = []
    with torch.no_grad():
        pmod(torch.tensor(x), None if pad is None else torch.tensor(pad))
    rec, pmod.record = pmod.record[0], None
    return rec


@pytest.mark.parametrize(
    "experts,cf,with_padding",
    [
        (1, 0.5, False),  # one expert: every score is exactly 1, all ties
        (2, 2.0, True),  # C = T: every padded token (score 0) is picked
        (4, 1.0, True),
    ],
)
def test_token_idx_is_bitwise_jax(experts, cf, with_padding):
    jmod, params, pmod, x = _module_pair(experts, cf, seed=2)
    pad = _padding(with_padding)
    _, inter = jmod.apply({"params": params}, jnp.asarray(x),
                          None if pad is None else jnp.asarray(pad),
                          mutable=["intermediates"])
    inter = jax.tree.map(np.asarray, inter["intermediates"])
    rec = _recorded(pmod, x, pad)
    np.testing.assert_array_equal(rec["token_idx"].numpy(), inter["token_idx"][0])
    np.testing.assert_allclose(rec["gates"].numpy(), inter["gates"][0], rtol=1e-6)
    np.testing.assert_allclose(rec["router_scores"].numpy(), inter["router_scores"][0],
                               rtol=1e-6)
    if experts == 1:  # JAX takes the lower index first among equal scores
        np.testing.assert_array_equal(rec["token_idx"].numpy()[:, 0],
                                      np.broadcast_to(np.arange(5), (B, 5)))


def test_single_expert_at_full_capacity_is_the_dense_ff():
    torch.manual_seed(0)
    dense = FeedForward(D, mult=4, fused=False)
    moe = MoEFeedForward(D, 1, mult=4, capacity_factor=1.0)
    with torch.no_grad():
        moe.experts["w_in"].copy_(dense.feedforward[0].weight.t()[None])
        moe.experts["w_out"].copy_(dense.feedforward[2].weight.t()[None])
        moe.router["weight"].normal_()
    x = torch.tensor(np.random.default_rng(3).normal(size=(B, T, D)).astype(np.float32))
    torch.testing.assert_close(moe(x), dense(x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["onehot", "gather"])
def test_padded_tokens_get_a_zero_ff_output(impl, monkeypatch):
    monkeypatch.setenv("MCA_MOE_IMPL", impl)  # the JAX module's arm
    jmod, params, pmod, x = _module_pair(1, 1.0, seed=4)  # C = T > 7 real tokens
    pad = np.zeros((B, T), bool)
    pad[:, 7:] = True
    with torch.no_grad():
        y = pmod(torch.tensor(x), torch.tensor(pad))
    assert (y[:, 7:] == 0).all() and (y[:, :7].abs().amin() > 0)
    jy = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(pad)))
    assert (jy[:, 7:] == 0).all()
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-6)


def _tiny(family="mca", **kw):
    kw = {**(EAO_KW if family == "eao" else {}), **kw}
    kw.setdefault("attention_impl", "pallas")
    kw.setdefault("moe_experts", 2)
    kw.setdefault("moe_capacity_factor", 2.0)
    return tiny_config("tcga", precision="fp32", **kw)


def _rows(n=8, seed=1):
    rows = make_tcga_like(n, widths=WIDTHS, p_missing=0.25, seed=seed)
    rows[2]["gene"]["values"][7:] = -10000.0  # a ragged tail
    return rows


def _jax_model(cfg_dict, rows):
    jmodel = jax_build_model(jax_model_config(jax_config(cfg_dict)))
    batch_np = JaxCollator(jax_config(cfg_dict).modality_config.to_plain())(rows)
    batch_j = jax.tree.map(jnp.asarray, batch_np)
    params = jax.jit(jmodel.init)(jax.random.key(0), batch_j)
    return jmodel, params, batch_np, batch_j


def _port_model(cfg_dict, params, fused_ff=False):
    model = build_model(get_model_config(training_config_from_dict(cfg_dict)), fused_ff=fused_ff)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)),
                          strict=True)
    return model


def test_parameters_carry_over_and_export_under_jax_names(tmp_path):
    cfg_dict = _tiny()
    _, params, _, _ = _jax_model(cfg_dict, _rows())
    model = _port_model(cfg_dict, params)
    exported = jax_export_state_dict(jax.tree.map(np.asarray, params))
    sd = model.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(np.shape(v)) for k, v in exported.items()}
    inner = int(32 * 4 * 2 / 3)
    assert sd["layers.0.ff.router.weight"].shape == (32, 2)
    assert sd["layers.1.ff.experts.w_in"].shape == (2, 32, 2 * inner)
    assert sd["layers.1.ff.experts.w_out"].shape == (2, inner, 32)
    for k, v in exported.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)

    path = tmp_path / "model.safetensors"
    checkpoint.export_safetensors(sd, str(path))
    raw = path.read_bytes()
    header = json.loads(raw[8 : 8 + struct.unpack("<Q", raw[:8])[0]])
    header.pop("__metadata__")
    assert {k: tuple(h["shape"]) for k, h in header.items()} == {
        k: tuple(np.shape(v)) for k, v in exported.items()}


def test_init_weights_draws_the_jax_scales():
    """The router ``[dim, E]`` at +-dim^-1/2 (not +-E^-1/2), each expert
    matrix at +-1/sqrt(its own input width)."""
    model = build_model(get_model_config(training_config_from_dict(
        _tiny(hidden=64, moe_experts=4))), fused_ff=False)
    model.init_weights(torch.Generator().manual_seed(0))
    ff = model.layers[0].ff
    inner = int(64 * 4 * 2 / 3)
    for p, bound in ((ff.router["weight"], 64 ** -0.5), (ff.experts["w_in"], 64 ** -0.5),
                     (ff.experts["w_out"], inner ** -0.5)):
        assert 0.9 * bound < float(p.detach().abs().max()) <= bound


def test_mca_forward_and_one_step_match_jax(monkeypatch):
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    cfg_dict = _tiny()
    jmodel, params, batch_np, batch_j = _jax_model(cfg_dict, _rows())

    def loss(p, b):
        out = jmodel.apply(p, b)
        return out["loss"], out

    (jloss, jout), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params, batch_j)
    jgrads = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads))

    model = _port_model(cfg_dict, params)
    out = model(port_train.to_device(batch_np, "cpu"), no_loss=False)
    for k in sorted(k for k in jout if k not in ("losses", "modality_sample_mask")):
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(jout[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(out["loss"]), float(jloss), rtol=1e-4)
    out["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    flat = torch.cat([grads[n].reshape(-1) for n in jgrads])
    want = torch.cat([v.reshape(-1) for v in jgrads.values()])
    assert float((flat - want).norm() / want.norm()) <= 1e-4
    for name in ("layers.0.ff.router.weight", "layers.1.ff.experts.w_in",
                 "layers.1.ff.experts.w_out"):
        v = jgrads[name].numpy()
        assert np.abs(v).max() > 0, name
        np.testing.assert_allclose(grads[name].numpy(), v, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(v).max()), err_msg=name)


def test_eao_forward_matches_jax(monkeypatch):
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    jmodel, params, batch_np, batch_j = _jax_model(_tiny("eao", attention_impl="dense"),
                                                   _rows())
    jout = jax.tree.map(np.asarray, jax.jit(jmodel.apply)(params, batch_j))
    model = _port_model(_tiny("eao"), params, fused_ff=True).eval()
    with torch.inference_mode():
        out = model(port_train.to_device(batch_np, "cpu"))
    keys = sorted(k for k in jout if k not in ("losses", "modality_sample_mask"))
    assert keys == sorted(k for k in out if k not in ("losses", "modality_sample_mask"))
    for k in keys:
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("family", ["mca", "eao"])
def test_remat_gradients_equal_the_plain_ones(family):
    cfg = training_config_from_dict(_tiny(family))
    batch = port_train.to_device(
        JaxCollator(jax_config(_tiny(family)).modality_config.to_plain())(_rows()), "cpu")
    plain = port_train.build_trainer(cfg, "cpu")[0]
    params = {k: v.clone() for k, v in plain.state_dict().items()}
    cfg.remat = True
    remat = port_train.build_trainer(cfg, "cpu", params=params)[0]
    assert remat.remat
    want = port_train.forward_backward(plain, batch)
    got = port_train.forward_backward(remat, batch)
    assert got["total_loss"] == want["total_loss"]
    for (n, p), (_, q) in zip(remat.named_parameters(), plain.named_parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-6, atol=1e-7, msg=n)


def test_quant_with_moe_is_refused():
    with pytest.raises(ValueError, match="moe_experts requires quant='none'"):
        MCALayer(16, 8, 2, 4, quant="int8", moe_experts=2)


def test_routing_is_per_sample():
    """A sample's embedding alone equals its embedding inside a batch:
    each expert picks tokens within a sample, never across the batch."""
    cfg = training_config_from_dict(_tiny(moe_capacity_factor=1.0))
    svc = EmbeddingService(cfg, device="cpu", max_batch=4, warmup=False)
    rows = [{m: r[m] for m in WIDTHS} for r in _rows(4, seed=5)]
    together = svc.embed(rows)
    for i, row in enumerate(rows):
        alone = svc.embed([row])
        for k, e in alone["embeddings"].items():
            np.testing.assert_allclose(e[0], together["embeddings"][k][i], rtol=1e-6,
                                       atol=1e-6, err_msg=(i, k))


def _stats_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, float):
                np.testing.assert_allclose(g[k], v, rtol=1e-6, err_msg=k)
            elif isinstance(v, list):
                np.testing.assert_allclose(g[k], v, atol=2e-6, err_msg=k)
            else:
                assert g[k] == v, (k, g[k], v)


def test_routing_stats_matches_jax():
    _, params, pmod, x = _module_pair(4, 1.0, seed=6)
    pad = _padding(True)
    rec = {k: v.numpy() for k, v in _recorded(pmod, x, pad).items()}
    args = (rec["router_scores"], rec["token_idx"], rec["gates"])
    _stats_equal([routing_stats(*args)], [jax_routing_stats(*args)])


def _stats_config(family):
    return _tiny(family, attention_impl="dense", moe_capacity_factor=1.0)


@pytest.fixture(scope="module")
def jax_moe_stats(tmp_path_factory):
    """Per family: the JAX tool's rows on an HF dataset of 12 rows, the
    rows and the dataset's directory, computed once for the module."""
    cache = {}

    def get(family):
        if family not in cache:
            rows = _rows(12, seed=7)
            ds = tmp_path_factory.mktemp(f"ds_{family}")
            to_hf_dataset(rows).save_to_disk(str(ds))
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("MCA_FUSED_FF", "0")
                want = jax_extract_moe_stats(
                    jax_config({**_stats_config(family), "dataset": str(ds)}))
            cache[family] = (want, rows, ds)
        return cache[family]

    return get


@pytest.mark.parametrize("family,source", [("mca", "rows"), ("mca", "disk"), ("eao", "rows")])
def test_extract_moe_stats_matches_jax(family, source, jax_moe_stats, tmp_path):
    """The same weights and batch: the JAX tool's fresh init (seed 0 on
    the first batch) carried into a checkpoint the port restarts from."""
    want, rows, ds = jax_moe_stats(family)
    cfg_dict = _stats_config(family)
    _, params, _, _ = _jax_model(cfg_dict, rows[:4])  # init reads shapes only
    save_dir = tmp_path / "weights"
    checkpoint.save_params(
        _port_model(cfg_dict, params).state_dict(), str(save_dir))
    cfg = training_config_from_dict({**cfg_dict, "restart": str(save_dir)})
    if source == "disk":
        cfg.dataset = str(ds)
        got = extract_moe_stats(cfg, device="cpu")
    else:
        got = extract_moe_stats(cfg, rows=rows, device="cpu")
    _stats_equal(got, want)
    # one row a layer; EAO one a layer and pass (4 modalities, 6 pairs)
    assert len(got) == cfg.layers * (10 if family == "eao" else 1)
    assert ("call" in got[0]) == (family == "eao")
    for r in got:
        assert 0 < r["coverage_real"] <= 1 and abs(sum(r["expert_prob_mass"]) - 1) < 1e-4


def test_extract_moe_stats_needs_moe_experts():
    cfg = training_config_from_dict(_tiny(moe_experts=0))
    with pytest.raises(ValueError, match="moe_experts > 0"):
        extract_moe_stats(cfg, rows=_rows(), device="cpu")


@pytest.mark.parametrize("family", ["mca", "eao"])
def test_moe_trains_and_infers_on_the_cpu(family, tmp_path):
    """The run and the evaluation path with ``moe_experts: 2``: finite
    step records, the final model (MoE leaves under the JAX package's
    names in ``model.safetensors``) and the six embedding files."""
    from mca_tpu_torch import infer as port_infer

    cfg = training_config_from_dict({**_tiny(family), "output_dir": str(tmp_path / "run")})
    rows = _rows(16, seed=8)  # split 0.25: 3 train batches of 4, 1 eval batch
    logged = []
    port_train.train(cfg, device="cpu", rows=rows, log=logged.append)
    steps = [r for r in logged if "total_loss" in r]
    assert len(steps) == 3 and all(np.isfinite(r["total_loss"]) for r in steps)
    raw = (tmp_path / "run" / "model.safetensors").read_bytes()
    names = json.loads(raw[8 : 8 + struct.unpack("<Q", raw[:8])[0]])
    assert {"layers.0.ff.router.weight", "layers.1.ff.experts.w_in",
            "layers.1.ff.experts.w_out"} <= set(names)

    cfg.restart = str(tmp_path / "run")
    cfg.output_dir = str(tmp_path / "emb")
    port_infer.infer(cfg, device="cpu", rows=rows)
    for split in ("train", "eval"):
        emb = port_infer.load_embedding_file(str(tmp_path / "emb" / f"{split}_embeddings"))
        assert emb and all(np.isfinite(v).all() for v in emb.values())
