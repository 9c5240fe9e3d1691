"""EAO training in the port against the JAX package's.

EAO (``eao: true``: no fusion tokens, a mean pool, ``fusion_combos:
[2]``) at the tiny TCGA shape (widths 12/8/10/6, dim 32, depth 2, 2
heads x 16, fp32) takes 6 steps from the JAX model's ``init`` weights on
two alternating numpy batches, in each package: the port runs every
pass through the flash path's plain versions on the CPU (with and
without ``eao_group_channels``), the JAX package its dense attention
(its plain reference; the two differ only in rows whose every key is
padded, which the mean pool leaves out) and the unfused feed-forward.
On the card these passes run K1 forward and K2 (or K3a + K3b) backward
unmasked; here the plain backward those kernels are held to is also
checked against autograd through dense attention at odd tile counts.
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
from mca_tpu.train import hf_lr_schedule as jax_hf_lr_schedule
from mca_tpu.train import init_state, make_optimizer, make_train_step
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.models import EAO
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops.attention import dense_masked_attention

torch.backends.cuda.matmul.allow_tf32 = False

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
EAO_KW = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
              fusion_combos=[2], fcl_root=[0, 1])
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(side="port", **overrides):
    impl = "dense" if side == "jax" else "pallas"
    return tiny_config("tcga", widths=WIDTHS, attention_impl=impl, precision="fp32",
                       **EAO_KW, **overrides)


def _batches():
    rows = make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=0)
    rows[2]["gene"]["values"][7:] = -10000.0  # a ragged tail
    collate = JaxCollator(jax_config(_cfg()).modality_config.to_plain())
    return [collate(rows[i : i + 4]) for i in (0, 4)]


@pytest.fixture(scope="module")
def jax_trajectory():
    """The JAX package's 6 EAO steps: ``(initial params, metrics)``."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MCA_FUSED_FF", "0")
        jcfg = jax_config(_cfg("jax"))
        jmodel = jax_build_model(jax_model_config(jcfg))
        tx = make_optimizer(jcfg, num_training_steps=STEPS)
        schedule = jax_hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps,
                                      STEPS)
        bj = [jax.tree.map(jnp.asarray, b) for b in _batches()]
        state = init_state(jmodel, tx, bj[0], seed=0)
        params0 = jax.tree.map(np.asarray, state["params"])
        step = make_train_step(jmodel, tx, schedule)
        history = []
        for i in range(STEPS):
            state, metrics = step(state, bj[i % 2])
            history.append({k: float(v) for k, v in metrics.items()})
    return params0, history


@pytest.mark.parametrize("grouped", [False, True], ids=["sequential", "group_channels"])
def test_six_step_eao_trajectory_matches_jax(jax_trajectory, grouped):
    """fp32, the same arithmetic in another order through AdamW's
    normalised updates: 1e-4 over 6 steps (with an absolute floor for
    pair losses near 0)."""
    params0, jhist = jax_trajectory
    cfg = training_config_from_dict(_cfg(eao_group_channels=grouped))
    model, opt, sched = port_train.build_trainer(
        cfg, "cpu", num_training_steps=STEPS, params=state_dict_from_jax_params(params0))
    assert isinstance(model, EAO) and model.group_channels == grouped
    batches = _batches()
    calls = []
    real = flash.flash_attention_bwd_reference

    def counted(*args, **kw):
        calls.append(args[0].shape[2])
        return real(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(flash, "flash_attention_bwd_reference", counted)
        phist = [port_train.train_step(model, opt, sched,
                                       port_train.to_device(batches[i % 2], "cpu"),
                                       clip=cfg.clip, dropout_seed=int(cfg.seed))
                 for i in range(STEPS)]
    assert set(phist[0]) == set(jhist[0])
    for i, (p, j) in enumerate(zip(phist, jhist)):
        for k, v in j.items():
            if np.isnan(v):
                assert np.isnan(p[k]), (i, k)
            else:
                np.testing.assert_allclose(p[k], v, rtol=1e-4, atol=1e-6, err_msg=f"step {i} {k}")
    assert phist[-1]["total_loss"] < phist[0]["total_loss"]
    # every pass's backward went through the flash path: 10 passes (6
    # when channels of equal length share one) x 2 blocks x 6 steps
    lengths = sorted(set(calls))
    assert lengths == sorted({12, 8, 10, 6, 20, 22, 18, 16, 14})
    assert len(calls) == STEPS * 2 * (len(lengths) if grouped else 10)


@pytest.mark.parametrize("t", [13 * 64 - 32, 25 * 64, 10 * 64 + 22])
def test_plain_backward_at_odd_tile_counts_matches_autograd(t):
    """The plain backward the kernels are held to, unmasked (as EAO calls
    it) at odd tile counts, against autograd through dense attention in
    fp32, on every query row with a live key; padded keys get no
    gradient."""
    rng = np.random.default_rng(t)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, t, 64)).astype(np.float32))
               .requires_grad_(True) for _ in range(3))
    pad = torch.zeros((2, t), dtype=torch.bool)
    pad[0, t - 40 :] = True  # a ragged tail into the last tile
    pad[1, : t // 3] = True
    do = torch.from_numpy(rng.normal(size=(2, 2, t, 64)).astype(np.float32))
    out, _ = flash.flash_attention(q, k, v, None, pad, 0.125)
    got = torch.autograd.grad(out, (q, k, v), do)
    want_out = dense_masked_attention(q, k, v, scale=0.125, key_padding_mask=pad)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    torch.testing.assert_close(out, want_out, rtol=1e-5, atol=1e-5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5, msg=name)
    padded = pad[:, None, :].expand(2, 2, t)
    assert not got[1][padded].any() and not got[2][padded].any()
    assert -(-t // flash.BLOCK) % 2 == 1
