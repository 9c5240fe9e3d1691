"""The port's training step against the JAX package's.

The tiny TCGA model (``tiny_config("tcga", attention_impl="pallas")``:
4 tabular modalities of widths 12/8/10/6, dim 32, depth 2, 2 heads x 16,
FCL + bimodal + non-fusion FCL, clip 2.0, lr 1e-3, 2 warm-up steps) is
initialised in JAX, carried into the port with
``state_dict_from_jax_params``, and both take the same steps on the same
numpy batches.  The JAX side trains as it does by default: the unfused
feed-forward (``MCA_FUSED_FF=0``) and the flash kernels in interpret
mode; the port runs on the CPU through the plain versions.

Also: the HF schedule's values, the feed-forward repair (every weight
JAX gives a gradient gets one, and the fused path refuses to run
detached from autograd), the logit-scale clamp and the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like as jax_make_tcga_like
from mca_tpu.data.synthetic import tiny_config
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.train import hf_lr_schedule as jax_hf_lr_schedule
from mca_tpu.train import init_state, make_optimizer, make_train_step
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.data.synthetic import make_tcga_like
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.losses import LOGIT_SCALE_MAX, LOGIT_SCALE_MIN
from mca_tpu_torch.models import build_model

torch.backends.cuda.matmul.allow_tf32 = False

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
STEPS = 6


def _cfg(precision="fp32"):
    return tiny_config("tcga", precision=precision, attention_impl="pallas")


def _rows():
    return make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=0)


def _batches(cfg_dict):
    """Two numpy batches of 4 rows, collated by the JAX collator."""
    rows = _rows()
    collate = JaxCollator(jax_config(cfg_dict).modality_config.to_plain())
    return [collate(rows[i : i + 4]) for i in (0, 4)]


def _jax_setup(monkeypatch, cfg_dict):
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    jcfg = jax_config(cfg_dict)
    model = jax_build_model(jax_model_config(jcfg))
    return jcfg, model


def _port_batch(batch_np):
    return port_train.to_device(batch_np, "cpu")


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant_with_warmup", "constant"])
def test_hf_lr_schedule_matches_jax(kind):
    jax_s = jax_hf_lr_schedule(kind, 3e-4, 5, 20)
    port_s = port_train.hf_lr_schedule(kind, 3e-4, 5, 20)
    steps = np.arange(25)
    # JAX evaluates in fp32, the port in fp64: agreement to fp32 rounding
    np.testing.assert_allclose(
        [port_s(int(s)) for s in steps], [float(jax_s(s)) for s in steps],
        rtol=1e-6, atol=1e-12,
    )


def test_synthetic_rows_match_jax():
    for a, b in zip(_rows(), jax_make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=0)):
        assert a.keys() == b.keys()
        for m in a:
            np.testing.assert_array_equal(a[m]["values"], b[m]["values"])


def test_one_step_gradients_match_jax(monkeypatch):
    cfg_dict = _cfg()
    jcfg, jmodel = _jax_setup(monkeypatch, cfg_dict)
    batch_np = _batches(cfg_dict)[0]
    batch_j = jax.tree.map(jnp.asarray, batch_np)
    params = jax.jit(jmodel.init)(jax.random.key(0), batch_j)
    jgrads = jax.jit(
        jax.grad(lambda p, b: jmodel.apply(p, b)["loss"])
    )(params, batch_j)
    jgrads = state_dict_from_jax_params(jax.tree.map(np.asarray, jgrads))

    cfg = training_config_from_dict(cfg_dict)
    model = build_model(get_model_config(cfg), fused_ff=False)
    model.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, params)))
    out = model(_port_batch(batch_np), no_loss=False)
    out["loss"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert grads.keys() == jgrads.keys()
    for name, want in jgrads.items():
        want = want.numpy()
        if not np.any(want):
            continue
        # the FF repair: every weight JAX gives a gradient gets one here
        got = grads[name]
        assert got is not None and bool(got.abs().sum() > 0), name
        # fp32 both sides, sums in another order; entries that cancel to
        # near zero get an absolute floor at 1e-4 of the tensor's largest
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()),
            err_msg=name,
        )
    assert any(".ff.feedforward.0." in n for n in jgrads)


def test_fused_ff_refuses_to_run_detached_from_autograd():
    cfg = training_config_from_dict(_cfg())
    model = build_model(get_model_config(cfg), fused_ff=True)
    batch = _port_batch(_batches(_cfg())[0])
    with pytest.raises(RuntimeError, match="forward-only"):
        model(batch, no_loss=False)
    with torch.no_grad():
        out = model(batch, no_loss=False)  # serving-style use is fine
    assert torch.isfinite(out["loss"])


def _jax_trajectory(monkeypatch, cfg_dict, batches):
    jcfg, jmodel = _jax_setup(monkeypatch, cfg_dict)
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = jax_hf_lr_schedule(
        jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS
    )
    bj = [jax.tree.map(jnp.asarray, b) for b in batches]
    state = init_state(jmodel, tx, bj[0], seed=0)
    params0 = jax.tree.map(np.asarray, state["params"])
    step = make_train_step(jmodel, tx, schedule)
    history = []
    for i in range(STEPS):
        state, metrics = step(state, bj[i % 2])
        history.append({k: float(v) for k, v in metrics.items()})
    return params0, history


def _port_trajectory(cfg_dict, params0, batches):
    cfg = training_config_from_dict(cfg_dict)
    model, opt, sched = port_train.build_trainer(
        cfg, "cpu", num_training_steps=STEPS,
        params=state_dict_from_jax_params(params0),
    )
    return [
        port_train.train_step(model, opt, sched, _port_batch(batches[i % 2]), clip=cfg.clip)
        for i in range(STEPS)
    ]


@pytest.mark.parametrize(
    "precision,rtol",
    [
        # fp32: the same arithmetic in another order, through AdamW's
        # normalised updates: 1e-4 relative over 6 steps
        ("fp32", 1e-4),
        # bf16: both round activations to bf16 (8 significant bits) but
        # at different places (XLA fuses some casts away), and AdamW's
        # first steps move every weight by about lr whatever its
        # gradient's size: 2e-2 relative over 6 steps
        ("bf16", 2e-2),
    ],
)
def test_six_step_trajectory_matches_jax(monkeypatch, precision, rtol):
    cfg_dict = _cfg(precision)
    batches = _batches(cfg_dict)
    params0, jhist = _jax_trajectory(monkeypatch, cfg_dict, batches)
    phist = _port_trajectory(cfg_dict, params0, batches)
    assert set(phist[0]) == set(jhist[0])
    for i, (p, j) in enumerate(zip(phist, jhist)):
        for k in ("total_loss", "fcl_loss", "no-fcl_loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(p[k], j[k], rtol=rtol, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(p["lr"], j["lr"], rtol=1e-6, err_msg=f"step {i} lr")
        for k in p:  # the per-pair losses, NaN where a pair is empty
            if np.isnan(j[k]):
                assert np.isnan(p[k]), (i, k)
    assert phist[-1]["total_loss"] < phist[0]["total_loss"]


@pytest.mark.parametrize("start", [10.0, -3.0])
def test_logit_scale_clamp_holds(start):
    cfg = training_config_from_dict(_cfg())
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=4)
    with torch.no_grad():
        model.loss.loss_fn.logit_scale.fill_(start)
    batch = _port_batch(_batches(_cfg())[0])
    # the parameter is fp32: the bounds as fp32 values
    lo, hi = float(np.float32(LOGIT_SCALE_MIN)), float(np.float32(LOGIT_SCALE_MAX))
    values = []
    for _ in range(3):
        port_train.train_step(model, opt, sched, batch, clip=cfg.clip)
        values.append(float(model.loss.loss_fn.logit_scale.detach()))
    assert all(lo <= x <= hi for x in values), values
    # step 0 runs at lr 0 (warm-up), so only the clamp moves the value
    assert values[0] == (hi if start > 0 else lo)


def test_cli_writes_one_metrics_line_per_step(tmp_path):
    import yaml

    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg()))
    out = tmp_path / "metrics.jsonl"
    port_train.main([str(cfg_path), "--synthetic", "12", "--steps", "3",
                     "--device", "cpu", "--metrics", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [m["step"] for m in lines] == [0, 1, 2]
    assert all(np.isfinite(m["total_loss"]) for m in lines)
    assert lines[0]["lr"] == 0.0 and lines[1]["lr"] > 0  # 2 warm-up steps

    cfg_path.write_text(yaml.safe_dump({**_cfg(), "dataset": "data/tcga_dataset"}))
    with pytest.raises(NotImplementedError, match="dataset loader"):
        port_train.main([str(cfg_path), "--device", "cpu"])
