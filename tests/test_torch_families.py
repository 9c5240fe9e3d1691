"""The port's model families against the JAX package's: MMA/Zorro,
``no_fusion``, MCA with ``mean_pool``, and EAO (also with
``eao_group_channels``).

Each family is built at the tiny TCGA shape (4 tabular modalities of
widths 12/8/10/6, dim 32, depth 2, 2 heads x 16, fp32), initialised in
JAX, carried into the port with ``state_dict_from_jax_params`` and
``load_state_dict(strict=True)``, and both run the same numpy batch:
the forward with its loss graph, then the loss and gradient of one
training step.  The port runs the flash path on the CPU through its
plain versions.  The JAX side runs the unfused feed-forward and, for
the MCA families, its flash kernels in interpret mode; for EAO, whose
ten passes take interpret mode half a minute to compile, its dense
attention, the package's plain reference (the two differ only in rows
whose every key is padded, which the mean pool leaves out).  The
grouped EAO port is held to the JAX package's sequential EAO, which the
package's own tests pin equal to its grouped one
(``tests/test_eao_parity.py``); at these widths two channels of length
18 share a pass.  JAX compiles each family once, for one
``value_and_grad`` whose outputs both tests read.
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
from mca_tpu.interop import build_key_map as jax_build_key_map
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.models.pool import MeanTokenProjectionPool as JaxPool
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.interop import build_key_map, state_dict_from_jax_params
from mca_tpu_torch.models import EAO, MCA, build_model
from mca_tpu_torch.models.pool import MeanTokenProjectionPool
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops.attention import dense_masked_attention

torch.backends.cuda.matmul.allow_tf32 = False

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
EAO_KW = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
              fusion_combos=[2], fcl_root=[0, 1])
FAMILIES = {
    "mma_zorro": dict(zorro=True),
    # no fusion tokens: the pooled fusion-channel combos need them, so
    # fcl is off (the JAX package asserts the same)
    "no_fusion": dict(no_fusion=True, fcl=False),
    "mean_pool": dict(mean_pool=True, zorro=True),
    "eao": EAO_KW,
    "eao_grouped": dict(EAO_KW, eao_group_channels=True),
}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores, where per-worker thread pools
    oversubscribe them and slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(family, side="port"):
    kw = FAMILIES[family]
    impl = "dense" if side == "jax" and kw.get("eao") else "pallas"
    return tiny_config("tcga", attention_impl=impl, precision="fp32", **kw)


def _jax_run(family):
    """The JAX package's ``(params, outputs, loss, gradients)`` on the
    family's batch (numpy leaves; the gradients under the port's names),
    and the batch."""
    d = _config("eao" if family == "eao_grouped" else family, side="jax")
    rows = make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=1)
    rows[2]["gene"]["values"][7:] = -10000.0  # a ragged tail
    batch_np = JaxCollator(jax_config(d).modality_config.to_plain())(rows)
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
    """:func:`_jax_run` per family, computed once for the module."""
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")

        def get(family):
            key = "eao" if family == "eao_grouped" else family
            if key not in cache:
                cache[key] = _jax_run(key)
            return cache[key]

        yield get


def _port(jax_runs, family):
    params, jout, jloss, jgrads, batch_np = jax_runs(family)
    cfg = training_config_from_dict(_config(family))
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
    assert sorted(jout["losses"]) == sorted(out["losses"])
    # fp32 both sides, sums in another order: 1e-4 relative, with an
    # absolute floor for entries near zero
    for k in keys:
        np.testing.assert_allclose(out[k].numpy(), jout[k], rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in jout["losses"].items():
        np.testing.assert_allclose(float(out["losses"][k]), float(v), rtol=1e-4, err_msg=k)
    for m, present in jout["modality_sample_mask"].items():
        np.testing.assert_array_equal(out["modality_sample_mask"][m].numpy(), present)
    assert isinstance(model, EAO if family.startswith("eao") else MCA)
    if family.startswith("eao"):
        assert "fusion" not in out and len(keys) == 4 + 6 + 3  # + loss, fcl_loss, no-fcl_loss


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
    # the step itself: its reported gradient norm is JAX's gradient's
    opt, schedule = port_train.make_optimizer(
        model, training_config_from_dict(_config(family)), 10)
    metrics = port_train.train_step(model, opt, schedule, batch, clip=2.0)
    np.testing.assert_allclose(metrics["grad_norm"], float(want.norm()), rtol=1e-4)
    np.testing.assert_allclose(metrics["total_loss"], jloss, rtol=1e-4)


@pytest.mark.parametrize("family", ["eao", "mean_pool"])
def test_parameter_free_pool_leaves_no_pool_entry(jax_runs, family):
    """EAO's and mean_pool's ``attn_pool`` is a MeanTokenProjectionPool
    without projections: the JAX tree holds no pool entry, so neither
    the ``attn_pool`` nor the ``pool`` branch of the key map is reached,
    and the port's state dict has no ``attn_pool`` key either."""
    params = jax_runs(family)[0]
    model = _port(jax_runs, family)[0]
    assert not {"attn_pool", "pool"} & set(params["params"])
    assert not any(k.startswith("attn_pool") for k in model.state_dict())
    assert build_key_map(params) == jax_build_key_map(params)


@pytest.mark.parametrize("key", ["pool", "attn_pool"])
@pytest.mark.parametrize("token_types", [None, (0, 0, 1, 1, 1, -1, -2)])
def test_mean_pool_with_projections_matches_jax(key, token_types):
    """A projecting mean pool (a type with no valid token pools to zero
    before its projection) carried through the ``pool`` key map."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 6)).astype(np.float32)
    pad = rng.random((3, 7)) < 0.4
    pad[1, 2:5] = True  # sample 1 has no token of type 1
    jpool = JaxPool(token_types=token_types, in_dim=6, out_dim=5, projection=True)
    p = jpool.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(pad))
    p = jax.tree.map(lambda a: np.asarray(a) + rng.normal(size=a.shape).astype(np.float32), p)
    want = np.asarray(jpool.apply(p, jnp.asarray(x), jnp.asarray(pad)))
    sd = state_dict_from_jax_params({key: p["params"]})
    pool = MeanTokenProjectionPool(token_types=token_types, in_dim=6, out_dim=5, projection=True)
    pool.load_state_dict({k.removeprefix("attn_pool."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = pool(torch.from_numpy(x), torch.from_numpy(pad)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if token_types is None:
        assert got.shape == (3, 1, 5)
    else:
        assert got.shape == (3, 4, 5)  # types 0, 1, then -1, -2


def test_mean_pool_with_fcl_raises():
    d = tiny_config("tcga", mean_pool=True)  # fcl on, zorro off
    with pytest.raises(ValueError, match="mean_pool"):
        build_model(get_model_config(training_config_from_dict(d)))


@pytest.mark.parametrize("dims", [(198,), (800, 800)])
def test_unmasked_flash_at_eao_lengths(dims):
    """EAO's passes call the flash path without a static mask: one
    all-live mask per length (so K1's schedule is built once a length),
    whose schedule visits every kv tile from every q tile, and the plain
    version matches dense attention on every row with a live key."""
    t = sum(dims)
    mask = flash.all_live_mask(t)
    assert mask is flash.all_live_mask(t) and mask.shape == (t, t) and not mask.any()
    row_ptr, col_idx, _ = flash.tile_schedule(mask)
    nt = -(-t // flash.BLOCK)
    assert (np.diff(row_ptr) == nt).all() and len(col_idx) == nt * nt
    pair_ptr, pair_kv, flags, _ = flash.pair_schedule(mask)
    assert len(pair_ptr) - 1 == -(-nt // 2) and (np.diff(pair_ptr) == nt).all()
    # both halves visit every tile, but a last pair's missing second tile
    assert int((flags & 3 == 3).sum()) == (nt // 2) * nt
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 1, t, 64)).astype(np.float32))
               for _ in range(3))
    pad = torch.zeros((2, t), dtype=torch.bool)
    pad[0, dims[0] - 37 : dims[0]] = True  # a ragged tail
    pad[1, : dims[0]] = True  # sample 1 misses the first modality
    out, _ = flash.flash_attention(q, k, v, None, pad, 0.125)
    want = dense_masked_attention(q, k, v, scale=0.125, key_padding_mask=pad)
    live = ~pad.all(dim=1)
    np.testing.assert_allclose(out[live].numpy(), want[live].numpy(), rtol=1e-5, atol=1e-5)
    if len(dims) == 1:
        assert not bool(out[1].any())  # every key padded: zeros, as K1 gives
