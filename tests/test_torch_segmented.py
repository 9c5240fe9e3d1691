"""The port's ``attention_impl: segmented`` against the JAX package's.

``analyze_mask`` must split a mask's query rows as JAX's does (the MCA,
zorro and unmasked masks, and TCGA_config1's and CMU_config1's own);
the segmented op's output and its q / k / v gradients must equal JAX's
``segmented_masked_attention`` (Pallas in interpret mode) and the port's
dense path on every live row, at 1e-4 in fp32; an MCA model built with
``attention_impl: segmented`` must give JAX's embeddings and one-step
gradients on the same weights.  On the CPU the segments run through the
flash path's plain versions (the kernels on CUDA tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu import masks as jax_masks
from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.ops.segmented_attention import analyze_mask as jax_analyze
from mca_tpu.ops.segmented_attention import segmented_masked_attention as jax_segmented
from mca_tpu_torch import masks as port_masks
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.models import build_model
from mca_tpu_torch.ops import attention as port_attention
from mca_tpu_torch.ops import flash_attention as port_flash
from mca_tpu_torch.ops import segmented_attention as port_seg
from mca_tpu_torch.train import to_device

SCALE = 0.125
TOL = 1e-4  # fp32 on both sides; sums in another order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dims,fusion,combos,kw", [
    ([96, 64, 96], 70, [3, 2, 1], {}),
    ([96, 64], 30, [2, 1], {"zorro": True}),
    ([800, 198, 800, 662], 88, [4, 3, 2], {"fcl": True}),  # TCGA_config1
    ([1500, 450, 450, 50], 88, [4, 3, 2], {"fcl": True}),  # CMU_config1
])
def test_analyze_mask_matches_jax(dims, fusion, combos, kw):
    mask = port_masks.build_masks(dims, fusion, combos, **kw).attn_mask
    np.testing.assert_array_equal(mask, jax_masks.build_masks(dims, fusion, combos, **kw).attn_mask)
    segments, cross = port_seg.analyze_mask(mask)
    assert (segments, cross) == jax_analyze(mask)
    starts = np.cumsum([0] + dims[:-1])
    assert segments == [(int(s), d) for s, d in zip(starts, dims)]
    assert sum(n for _, n in cross) == fusion


def test_analyze_mask_unmasked():
    assert port_seg.analyze_mask(np.zeros((64, 64), bool)) == ([(0, 64)], [])


def _inputs(t, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 2, t, 64)).astype(np.float32) for _ in range(4)]


def _live_rows(mask, pad):
    blocked = np.asarray(mask)[None] | np.asarray(pad)[:, None, :]
    return ~blocked.all(axis=2)


@pytest.mark.parametrize("zorro", [False, True])
def test_segmented_forward_and_gradients_match_jax_and_dense(zorro):
    ms = port_masks.build_masks([96, 64], 30, [2, 1], zorro=zorro)
    t = ms.seq_len
    pad = np.zeros((2, t), bool)
    pad[0, :96] = True  # modality 0 missing in sample 0: dead segment rows
    pad[1, 96 + 20: 96 + 64] = True  # a ragged tail
    q, k, v, w = _inputs(t)

    def jax_obj(q, k, v):
        o = jax_segmented(q, k, v, scale=SCALE, attn_mask=ms.attn_mask,
                          key_padding_mask=jnp.asarray(pad), interpret=True)
        return (o * w).sum(), o

    (_, j_out), j_grads = jax.value_and_grad(jax_obj, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

    def port(impl):
        qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        o = port_attention.masked_attention(qt, kt, vt, scale=SCALE, attn_mask=ms.attn_mask,
                                            key_padding_mask=torch.from_numpy(pad), impl=impl)
        (o * torch.from_numpy(w)).sum().backward()
        return o.detach().numpy(), [x.grad.numpy() for x in (qt, kt, vt)]

    out, grads = port("segmented")
    np.testing.assert_allclose(out, np.asarray(j_out), atol=TOL, rtol=TOL)
    for name, got, want in zip("qkv", grads, j_grads):
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL, err_msg=f"d{name}")
    # against the dense path on the live rows (a dead row is 0 here,
    # a uniform average there)
    d_out, _ = port("dense")
    live = _live_rows(ms.attn_mask, pad)
    for b in range(2):
        np.testing.assert_allclose(out[b][:, live[b]], d_out[b][:, live[b]], atol=TOL, rtol=TOL)
    assert not out[0][:, :96].any()


def test_segments_go_through_the_flash_path(monkeypatch):
    """One flash call per segment (each unmasked, on its contiguous
    slice), the cross runs through the dense path; a traced mask is
    refused, and an unknown impl's message names segmented."""
    ms = port_masks.build_masks([96, 64, 40], 70, [3, 2, 1])
    calls = []
    real = port_flash.flash_attention

    def counted(q, k, v, attn_mask, pad, scale, bwd_impl=None):
        calls.append((q.shape[2], attn_mask, q.is_contiguous(), tuple(pad.shape)))
        return real(q, k, v, attn_mask, pad, scale, bwd_impl)

    monkeypatch.setattr(port_seg, "flash_attention", counted)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(ms.seq_len))
    pad = torch.zeros((2, ms.seq_len), dtype=torch.bool)
    port_attention.masked_attention(q, k, v, scale=SCALE, attn_mask=ms.attn_mask,
                                    key_padding_mask=pad, impl="segmented")
    assert calls == [(96, None, True, (2, 96)), (64, None, True, (2, 64)),
                     (40, None, True, (2, 40))]
    with pytest.raises(ValueError, match="static numpy"):
        port_attention.masked_attention(q, k, v, scale=SCALE,
                                        attn_mask=torch.from_numpy(ms.attn_mask),
                                        impl="segmented")
    with pytest.raises(NotImplementedError, match="segmented"):
        port_attention.masked_attention(q, k, v, scale=SCALE, impl="ring")


WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}


def test_segmented_model_matches_jax(monkeypatch):
    """TCGA-shaped MCA with ``attention_impl: segmented`` on both sides,
    weights carried by ``state_dict_from_jax_params``: the embeddings and
    the one-step gradients (fp32, 1e-4 relative, an absolute floor at
    1e-4 of a tensor's largest entry for entries that cancel)."""
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    d = tiny_config("tcga", batch_size=4, layers=1, precision="fp32",
                    attention_impl="segmented")
    jcfg = jax_config(d)
    jmodel = jax_build_model(jax_model_config(jcfg))
    rows = make_tcga_like(4, widths=WIDTHS, p_missing=0.25, seed=0)
    rows[2]["gene"]["values"][9:] = -10000.0  # a ragged tail
    batch_np = JaxCollator(jcfg.modality_config.to_plain())(rows)
    batch_j = jax.tree.map(jnp.asarray, batch_np)
    params = jax.jit(jmodel.init)(jax.random.key(0), batch_j)
    jout = jax.jit(lambda p, b: jmodel.apply(p, b, no_loss=True))(params, batch_j)
    jgrads = jax.jit(jax.grad(lambda p, b: jmodel.apply(p, b)["loss"]))(params, batch_j)
    jgrads = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads))

    cfg = training_config_from_dict(d)
    model = build_model(get_model_config(cfg), fused_ff=False)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    assert all(layer.attn.impl == "segmented" for layer in model.layers)
    batch = to_device(batch_np, "cpu")
    with torch.no_grad():
        tout = model(batch, no_loss=True)
    for key in model.loss.output_keys():
        np.testing.assert_allclose(tout[key].numpy(), np.asarray(jout[key]), rtol=TOL,
                                   atol=1e-5, err_msg=key)
    model(batch, no_loss=False)["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        want = want.numpy()
        if not np.any(want):
            continue
        np.testing.assert_allclose(grads[name].numpy(), want, rtol=TOL,
                                   atol=1e-4 * float(np.abs(want).max()), err_msg=name)


def test_plans_are_kept_per_mask_and_bounded():
    """An unmasked call keeps nothing; a static mask's plan is made once
    and reused; at most ``PLANS_KEPT`` plans are kept."""
    port_seg._PLANS.clear()
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(32))
    for _ in range(2):
        port_seg.segmented_masked_attention(q, k, v, scale=SCALE)
    assert not port_seg._PLANS
    ms = port_masks.build_masks([12, 10], 12, [2, 1])
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(ms.seq_len))
    for _ in range(2):
        port_seg.segmented_masked_attention(q, k, v, scale=SCALE, attn_mask=ms.attn_mask)
    assert [m is ms.attn_mask for m, _ in port_seg._PLANS.values()] == [True]
    for _ in range(port_seg.PLANS_KEPT + 3):
        port_seg.segmented_masked_attention(q, k, v, scale=SCALE,
                                            attn_mask=ms.attn_mask.copy())
    assert len(port_seg._PLANS) == port_seg.PLANS_KEPT
    port_seg._PLANS.clear()


def _interleaved_mask():
    """Segments (0, 8) and (12, 8), cross runs (8, 2), (10, 2) and
    (20, 4): two spans of cross rows, one between the segments."""
    t = 24
    mask = np.ones((t, t), bool)
    mask[:8, :8] = False
    mask[12:20, 12:20] = False
    mask[8:10] = False
    mask[10:12, 4:16] = False
    mask[20:] = False
    mask[20:, 3] = True
    return mask


def test_cross_runs_take_one_dense_call(monkeypatch):
    """Every cross run of a mask goes through one dense call, adjacent
    runs as one slice of q; with a span between the segments the result
    and the q / k / v gradients equal the dense path's (1e-4, fp32)."""
    calls = []
    real = port_seg.dense_masked_attention

    def counted(q, k, v, **kw):
        calls.append((q.shape[2], tuple(kw["attn_mask"].shape)))
        return real(q, k, v, **kw)

    monkeypatch.setattr(port_seg, "dense_masked_attention", counted)
    ms = port_masks.build_masks([96, 64, 40], 70, [3, 2, 1])
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(ms.seq_len))
    port_attention.masked_attention(q, k, v, scale=SCALE, attn_mask=ms.attn_mask,
                                    impl="segmented")
    assert len(port_seg.analyze_mask(ms.attn_mask)[1]) > 1
    assert calls == [(70, (70, ms.seq_len))]

    mask = _interleaved_mask()
    assert port_seg.analyze_mask(mask) == ([(0, 8), (12, 8)], [(8, 2), (10, 2), (20, 4)])
    calls.clear()
    q, k, v, w = _inputs(24, seed=1)
    pad = np.zeros((2, 24), bool)
    pad[1, 22:] = True

    def port(impl):
        qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        o = port_attention.masked_attention(qt, kt, vt, scale=SCALE, attn_mask=mask,
                                            key_padding_mask=torch.from_numpy(pad), impl=impl)
        (o * torch.from_numpy(w)).sum().backward()
        return [x.detach().numpy() for x in (o, qt.grad, kt.grad, vt.grad)]

    for name, got, want in zip(["out", "dq", "dk", "dv"], port("segmented"), port("dense")):
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=name)
    assert calls == [(8, (8, 24))]
    port_seg._PLANS.clear()


def test_segmented_eao_steps_match_jax(monkeypatch):
    """EAO (unmasked passes) with ``attention_impl: segmented``: two
    training steps from the JAX model's weights equal JAX's (its dense
    attention; fp32, 1e-4 relative), every pass one flash call of its
    own length, and nothing kept in the plan cache."""
    from mca_tpu.train import hf_lr_schedule, init_state, make_optimizer, make_train_step
    from mca_tpu_torch import train as port_train

    monkeypatch.setenv("MCA_FUSED_FF", "0")
    eao = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
               fusion_combos=[2], fcl_root=[0, 1], widths=WIDTHS, layers=1, precision="fp32")
    steps = 2
    jcfg = jax_config(tiny_config("tcga", attention_impl="dense", **eao))
    rows = make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=0)
    rows[2]["gene"]["values"][7:] = -10000.0  # a ragged tail
    collate = JaxCollator(jcfg.modality_config.to_plain())
    batches = [collate(rows[i: i + 4]) for i in (0, 4)]
    jmodel = jax_build_model(jax_model_config(jcfg))
    tx = make_optimizer(jcfg, num_training_steps=steps)
    step = make_train_step(jmodel, tx, hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr,
                                                      jcfg.num_warmup_steps, steps))
    state = init_state(jmodel, tx, jax.tree.map(jnp.asarray, batches[0]), seed=0)
    params0 = state_dict_from_jax_params(jax.tree.map(np.asarray, state["params"]))
    jhist = []
    for b in batches:
        state, metrics = step(state, jax.tree.map(jnp.asarray, b))
        jhist.append({k: float(v) for k, v in metrics.items()})

    cfg = training_config_from_dict(tiny_config("tcga", attention_impl="segmented", **eao))
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=steps,
                                                 params=params0)
    port_seg._PLANS.clear()
    lengths = []
    real = port_seg.flash_attention

    def counted(q, *args):
        lengths.append(q.shape[2])
        return real(q, *args)

    monkeypatch.setattr(port_seg, "flash_attention", counted)
    for i, b in enumerate(batches):
        p = port_train.train_step(model, opt, sched, to_device(b, "cpu"), clip=cfg.clip,
                                  dropout_seed=int(cfg.seed))
        for key, v in jhist[i].items():
            if np.isnan(v):
                assert np.isnan(p[key]), (i, key)
            else:
                np.testing.assert_allclose(p[key], v, rtol=TOL, atol=1e-6,
                                           err_msg=f"step {i} {key}")
    assert sorted(set(lengths)) == sorted({12, 8, 10, 6, 20, 22, 18, 16, 14})
    assert not port_seg._PLANS
