"""The port's int8 serving (``mca_tpu_torch/ops/quant.py``, the int8
layers, ``EmbeddingService(quantize="int8")``) against the JAX
package's ``mca_tpu/ops/quant.py``, on the CPU.

The weight quantisation is bitwise JAX's, a zero column included; the
activation rows and the s32 product of ``int8_dot`` are bitwise too, and
its output to fp32 rounding.  The quantised MCA, MMA/Zorro and EAO
forwards (2 blocks, width 64, fp32) run the JAX package's int8 weights,
carried by ``interop``, and the port's own quantisation of the carried
fp32 weights (bitwise the same): every output within relative L2 1e-3
per key.  An activation entry whose ``x / s_row`` lies within fp32
noise of a half rounds either way, moving by one int8 step; the test
counts such entries in the port's forward and prints the count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.ops import quant as jax_quant
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.models import build_model
from mca_tpu_torch.models.layers import Attention, FeedForward, MCALayer
from mca_tpu_torch.ops import quant
from mca_tpu_torch.serve import EmbeddingService

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
SMALL = dict(hidden=64, layers=2, heads=2, dim_head=32, precision="fp32")
EAO_KW = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
              fusion_combos=[2], fcl_root=[0, 1])
FAMILIES = {"mca": {}, "mma_zorro": dict(zorro=True), "eao": EAO_KW}
FORWARD_REL_L2 = 1e-3
COS_MIN = 0.98  # the JAX package's own pin (tests/test_quant.py)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes (the suite runs several
    pytest workers on shared cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_quantize_weight_is_bitwise_jax_with_a_zero_column():
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(64, 48)) * 0.3).astype(np.float32)
    w[:, 5] = 0.0  # its scale is eps / 127
    w[3, 7] = 0.5 * np.abs(w[:, 7]).max()  # an exact half step
    jq, js = jax_quant.quantize_weight(w)
    q, s = quant.quantize_weight(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy().view(np.int32), js.view(np.int32))
    assert (q[:, 5] == 0).all() and s[5] == np.float32(1e-8) / np.float32(127.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_dot_matches_jax(dtype):
    """Rows ``[3 x 40, 64]`` times an ``[64, 90]`` kernel (output width
    not a multiple of 8): the activation int8 and s32 product bitwise, y
    to fp32 rounding (bitwise in bf16, where the last cast rounds)."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 40, 64)).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: s_row = eps / 127
    w = (rng.normal(size=(64, 90)) * 0.2).astype(np.float32)
    jq, js = jax_quant.quantize_weight(w)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    # JAX's own rows, product and rescale (mca_tpu/ops/quant.py:66-76)
    xf = xj.astype(jnp.float32).reshape(-1, 64)
    s_row = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(xf / s_row), -127, 127).astype(jnp.int8)
    yq = jax.lax.dot_general(xq, jnp.asarray(jq), (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    mxq, ms_row = quant.quantize_rows(xt.reshape(-1, 64))
    np.testing.assert_array_equal(mxq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(ms_row.numpy(), np.asarray(s_row))
    myq = quant.int8_matmul(mxq, torch.from_numpy(jq))
    assert myq.dtype == torch.int32
    np.testing.assert_array_equal(myq.numpy(), np.asarray(yq))
    want = np.asarray(jax_quant.int8_dot(xj, jnp.asarray(jq), jnp.asarray(js)), np.float32)
    got = quant.int8_dot(xt, torch.from_numpy(jq), torch.from_numpy(js))
    assert got.dtype == xt.dtype and got.shape == (3, 40, 90)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-23, atol=0)


def test_int8_matmul_pads_exactly():
    """Few rows (the card's product takes more than 16) and widths off
    the multiple of 8: the padded product equals the plain integer one."""
    rng = np.random.default_rng(2)
    xq = torch.from_numpy(rng.integers(-127, 128, (5, 13)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (13, 9)).astype(np.int8))
    got = quant.int8_matmul(xq, wq)
    assert got.shape == (5, 9)
    np.testing.assert_array_equal(got.numpy(), xq.numpy().astype(np.int64) @ wq.numpy())


def _config(family, side="port"):
    kw = FAMILIES[family]
    impl = "dense" if side == "jax" and kw.get("eao") else "pallas"
    return tiny_config("tcga", attention_impl=impl, **SMALL, **kw)


def _jax_run(family):
    """The JAX package's fp32 params, int8 params and int8 outputs
    (numpy leaves) on the family's batch, and the batch."""
    d = _config(family, side="jax")
    rows = make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=1)
    rows[2]["gene"]["values"][7:] = -10000.0  # a ragged tail
    batch_np = JaxCollator(jax_config(d).modality_config.to_plain())(rows)
    batch_j = jax.tree.map(jnp.asarray, batch_np)
    mc = jax_model_config(jax_config(d))
    params = jax.jit(jax_build_model(mc).init)(jax.random.key(0), batch_j)
    qparams = jax_quant.quantize_params(params)
    qmodel = jax_build_model(dict(mc, quant="int8"))
    jout = jax.jit(lambda p, b: qmodel.apply(p, b, no_loss=True))(qparams, batch_j)
    leaves = (jax.tree.map(np.asarray, t) for t in (params, qparams, jout))
    return (*leaves, batch_np)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")

        def get(family):
            if family not in cache:
                cache[family] = _jax_run(family)
            return cache[family]

        yield get


def _port_model(family, state_dict, quantize="int8"):
    cfg = training_config_from_dict(_config(family))
    model = build_model(dict(get_model_config(cfg), quant=quantize), fused_ff=True)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _half_ties(model, batch):
    """Activation entries of every int8 projection whose ``x / s_row``
    lies within 2^-18 of a half: fp32 noise rounds them either way."""
    ties = []

    def hook(mod, args):
        x = args[0].reshape(-1, mod.weight_q.shape[0])
        r = x.float() / quant.quantize_rows(x)[1]
        ties.append(int(((r - r.floor() - 0.5).abs() < 2**-18).sum()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, quant.QuantLinear)]
    with torch.inference_mode():
        out = model(batch, no_loss=True)
    for h in handles:
        h.remove()
    return out, sum(ties)


def test_quantize_state_dict_is_bitwise_jax(jax_runs):
    """The port's quantisation of the carried fp32 weights against the
    JAX package's ``quantize_params`` carried by ``interop``: every entry
    bitwise, the int8 kernels ``[in, out]``, the pool untouched."""
    params, qparams, _, _ = jax_runs("mca")
    fp = state_dict_from_jax_params(params)
    mine = quant.quantize_state_dict(fp)
    want = state_dict_from_jax_params(qparams)
    assert sorted(mine) == sorted(want)
    n_q = 0
    for k, v in want.items():
        assert mine[k].dtype == v.dtype, k
        np.testing.assert_array_equal(mine[k].numpy(), v.numpy(), err_msg=k)
        n_q += k.endswith(".weight_q")
    assert n_q == 2 * 5  # 2 blocks x 5 projections
    assert want["layers.0.ff.feedforward.0.weight_q"].shape == (64, 2 * 170)
    for proj in ("to_q", "to_kv", "to_out"):
        assert f"attn_pool.{proj}.weight" in mine
        torch.testing.assert_close(mine[f"attn_pool.{proj}.weight"],
                                   fp[f"attn_pool.{proj}.weight"], rtol=0, atol=0)
    _port_model("mca", mine)  # loads strictly into the int8 model


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_forward_matches_jax(jax_runs, family, capsys):
    _, qparams, jout, batch_np = jax_runs(family)
    model = _port_model(family, state_dict_from_jax_params(qparams))
    out, ties = _half_ties(model, port_train.to_device(batch_np, "cpu"))
    keys = sorted(k for k in jout if k != "modality_sample_mask")
    assert keys == sorted(k for k in out if k != "modality_sample_mask")
    worst = 0.0
    for k in keys:
        want = np.asarray(jout[k], np.float64)
        rel = float(np.linalg.norm(out[k].numpy() - want) / np.linalg.norm(want))
        worst = max(worst, rel)
        assert rel <= FORWARD_REL_L2, (k, rel)
    for m, present in jout["modality_sample_mask"].items():
        np.testing.assert_array_equal(out["modality_sample_mask"][m].numpy(), present)
    with capsys.disabled():
        print(f"\n{family}: int8 forward vs JAX, worst relative L2 {worst:.3e}, "
              f"{ties} activation entries within 2^-18 of a half")


def _cos_min(a: np.ndarray, b: np.ndarray) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    na, nb = np.linalg.norm(a, axis=-1), np.linalg.norm(b, axis=-1)
    live = na > 1e-6
    return float(((a * b).sum(-1)[live] / (na[live] * nb[live])).min())


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_quantized_embeddings_close_to_fp(jax_runs, family):
    params, _, _, batch_np = jax_runs(family)
    fp = state_dict_from_jax_params(params)
    batch = port_train.to_device(batch_np, "cpu")
    fp_model = _port_model(family, fp, "none")
    q_model = _port_model(family, quant.quantize_state_dict(fp))
    with torch.inference_mode():
        out_fp = fp_model(batch, no_loss=True)
        out_q = q_model(batch, no_loss=True)
    for k, a in out_fp.items():
        if k != "modality_sample_mask":
            assert _cos_min(a.numpy(), out_q[k].numpy()) > COS_MIN, k


def test_service_int8_matches_direct_quantised_forward(jax_runs):
    params, _, _, _ = jax_runs("mca")
    fp = state_dict_from_jax_params(params)
    cfg = training_config_from_dict(_config("mca"))
    rows = make_tcga_like(6, widths=WIDTHS, p_missing=0.3, seed=4)
    svc = EmbeddingService(cfg, params=fp, max_batch=4, quantize="int8", device="cpu")
    assert svc.quantize == "int8"
    assert not any(k.endswith(".weight") and ("attn.to_" in k or "feedforward" in k)
                   and not k.startswith("attn_pool") for k in svc.model.state_dict())
    model = _port_model("mca", quant.quantize_state_dict(fp))
    batch = {m: {f: torch.from_numpy(v) for f, v in d.items()}
             for m, d in svc.collate(rows).items()}
    with torch.inference_mode():
        oracle = model(batch, no_loss=True)
    got = svc.embed(rows)  # 4 + 2, the second chunk padded
    for k in svc.emb_keys:
        np.testing.assert_allclose(got["embeddings"][k], oracle[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for m in svc.mask_keys:
        np.testing.assert_array_equal(got["present"][m],
                                      oracle["modality_sample_mask"][m].numpy())


def test_int8_layers_and_their_refusals():
    """The int8 blocks hold ``weight_q`` / ``scale`` buffers where the
    float ones hold ``weight``, run the unfused feed-forward (K5 never
    takes int8 weights), and MoE and unknown modes are refused."""
    ff = FeedForward(64, quant="int8")
    assert not ff.fused and sorted(ff.state_dict()) == [
        "feedforward.0.scale", "feedforward.0.weight_q",
        "feedforward.2.scale", "feedforward.2.weight_q"]
    attn = Attention(64, dim_head=32, heads=2, quant="int8")
    assert attn.to_kv.weight_q.shape == (64, 128) and attn.to_kv.weight_q.dtype == torch.int8
    with pytest.raises(ValueError, match="moe_experts"):
        MCALayer(64, 32, 2, 4, quant="int8", moe_experts=2)
    for cls, args in ((FeedForward, (64,)), (Attention, (64,))):
        with pytest.raises(ValueError, match="quant"):
            cls(*args, quant="int4")
    with pytest.raises(ValueError, match="quantize"):
        EmbeddingService(training_config_from_dict(_config("mca")), quantize="int4",
                         device="cpu")
