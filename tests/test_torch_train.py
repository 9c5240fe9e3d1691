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
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.synthetic import make_tcga_like
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.losses import LOGIT_SCALE_MAX, LOGIT_SCALE_MIN
from mca_tpu_torch.models import build_model

torch.backends.cuda.matmul.allow_tf32 = False

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
STEPS = 6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores, where per-worker thread pools
    oversubscribe them and slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    out = tmp_path / "out"
    # 12 rows, split 0.25: 9 train rows, 2 batches of 4 an epoch
    cfg_path.write_text(yaml.safe_dump({**_cfg(), "epochs": 2, "output_dir": str(out)}))
    port_train.main([str(cfg_path), "--synthetic", "12", "--device", "cpu"])
    lines = [json.loads(x) for x in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [m for m in lines if "total_loss" in m]
    assert [m["step"] for m in steps] == [1, 2, 3, 4]
    assert all(np.isfinite(m["total_loss"]) for m in steps)
    assert steps[0]["lr"] == 0.0 and steps[1]["lr"] > 0  # 2 warm-up steps

    cfg_path.write_text(yaml.safe_dump({**_cfg(), "dataset": str(tmp_path / "missing"),
                                        "output_dir": str(out)}))
    with pytest.raises(FileNotFoundError):  # the loader now reads dataset:
        port_train.main([str(cfg_path), "--device", "cpu"])


def test_initial_weights_and_shuffle_follow_config_seed(tmp_path):
    """The seed repair: ``config.seed`` draws the initial weights and
    orders the batches, as in the JAX package (the port once took a
    separate seed of 0 and cycled the rows in order)."""
    rows = make_tcga_like(12, widths=WIDTHS, p_missing=0.25, seed=0)
    cfg = training_config_from_dict({**_cfg(), "seed": 5})
    model = port_train.build_trainer(cfg, "cpu")[0]
    want = build_model(get_model_config(cfg), fused_ff=False)
    want.init_weights(torch.Generator().manual_seed(5))
    for k, v in want.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    other = port_train.build_trainer(training_config_from_dict({**_cfg(), "seed": 6}), "cpu")[0]
    assert not torch.equal(other.return_tokens, model.return_tokens)

    # the run's first step: those weights on the first batch that the
    # loader, shuffled from config.seed, draws
    from mca_tpu_torch.data.dataset import BatchedLoader, setup_data

    cfg.output_dir = str(tmp_path / "run")
    logged = []
    port_train.train(cfg, device="cpu", rows=rows, log=logged.append)
    model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=2)
    train_rows = setup_data(rows, split=cfg.split, ds_seed=cfg.ds_seed)["train"]
    loader = BatchedLoader(train_rows, MultimodalCollator(cfg.modality_config.to_plain()),
                           cfg.batch_size, shuffle=True, seed=5)
    first = port_train.train_step(model, opt, sched, _port_batch(next(iter(loader))),
                                  clip=cfg.clip)
    assert logged[0]["total_loss"] == first["total_loss"]
    in_order = port_train.train_step(
        *port_train.build_trainer(cfg, "cpu", num_training_steps=2),
        _port_batch(MultimodalCollator(cfg.modality_config.to_plain())(train_rows[:4])),
        clip=cfg.clip,
    )
    assert in_order["total_loss"] != first["total_loss"]


def _accum_case(monkeypatch, cfg_dict, batch_np, steps=2):
    """``steps`` steps of JAX's ``make_train_step(n_accum=2)`` and of the
    port's ``train_step(n_accum=2)`` from the same weights."""
    jcfg, jmodel = _jax_setup(monkeypatch, cfg_dict)
    tx = make_optimizer(jcfg, num_training_steps=STEPS)
    schedule = jax_hf_lr_schedule(jcfg.lr_scheduler_type, jcfg.lr, jcfg.num_warmup_steps, STEPS)
    bj = jax.tree.map(jnp.asarray, batch_np)
    state = init_state(jmodel, tx, bj, seed=0)
    params0 = jax.tree.map(np.asarray, state["params"])
    step = make_train_step(jmodel, tx, schedule, n_accum=2)
    jhist = []
    for _ in range(steps):
        state, metrics = step(state, bj)
        jhist.append({k: float(v) for k, v in metrics.items()})
    cfg = training_config_from_dict(cfg_dict)
    model, opt, sched = port_train.build_trainer(
        cfg, "cpu", num_training_steps=STEPS, params=state_dict_from_jax_params(params0)
    )
    phist = [port_train.train_step(model, opt, sched, _port_batch(batch_np), clip=cfg.clip,
                                   n_accum=2) for _ in range(steps)]
    jparams = state_dict_from_jax_params(jax.tree.map(np.asarray, state["params"]))
    return jhist, phist, jparams, model


def test_grad_accum_step_matches_jax(monkeypatch):
    cfg_dict = {**_cfg(), "batch_size": 8, "grad_accum": 2}
    rows = make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=0)
    batch_np = JaxCollator(jax_config(cfg_dict).modality_config.to_plain())(rows)
    jhist, phist, jparams, model = _accum_case(monkeypatch, cfg_dict, batch_np)
    for j, p in zip(jhist, phist):
        assert set(p) == set(j)
        for k, v in j.items():
            if np.isnan(v):
                assert np.isnan(p[k]), k
            else:  # fp32 both sides, sums in another order
                np.testing.assert_allclose(p[k], v, rtol=1e-5, err_msg=k)
    assert phist[1]["lr"] > 0
    for k, v in jparams.items():
        # one AdamW step at lr 5e-4 moves every weight by about lr
        # whatever its gradient: agreement to 1e-5 relative, with a floor
        # of 1e-5 of the tensor's largest entry
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(v.abs().max()), err_msg=k)


def test_grad_accum_averages_a_pair_over_the_microbatches_that_have_it(monkeypatch):
    """mirna is present only in rows 1 and 3 (microbatch 1, the rows
    i + 2k): its pair losses come from that microbatch alone, not NaN;
    protein is absent everywhere, so its pairs stay NaN; the gradient
    stays finite (``tests/test_grad_accum.py`` is the JAX oracle)."""
    cfg_dict = {**_cfg(), "grad_accum": 2}
    rows = make_tcga_like(4, widths=WIDTHS, p_missing=0.0, seed=3)
    for i, r in enumerate(rows):
        r["protein"]["values"][:] = -10000.0
        if i % 2 == 0:
            r["mirna"]["values"][:] = -10000.0
    batch_np = JaxCollator(jax_config(cfg_dict).modality_config.to_plain())(rows)
    jhist, phist, _, model = _accum_case(monkeypatch, cfg_dict, batch_np, steps=1)
    j, p = jhist[0], phist[0]
    mirna = [k for k in p if "mirna" in k and "protein" not in k]
    protein = [k for k in p if "protein" in k]
    assert mirna and protein
    for k in mirna:
        assert np.isfinite(p[k]) and np.isfinite(j[k]), k
        np.testing.assert_allclose(p[k], j[k], rtol=1e-5, err_msg=k)
    for k in protein:
        assert np.isnan(p[k]) and np.isnan(j[k]), k
    assert np.isfinite(p["grad_norm"]) and np.isfinite(p["total_loss"])
    np.testing.assert_allclose(p["grad_norm"], j["grad_norm"], rtol=1e-5)
    assert all(torch.isfinite(q.grad).all() for q in model.parameters())


def test_bf16_moments_trajectory_matches_jax(monkeypatch, tmp_path):
    cfg_dict = {**_cfg(), "moment_dtype": "bf16"}
    batches = _batches(cfg_dict)
    params0, jhist = _jax_trajectory(monkeypatch, cfg_dict, batches)
    cfg = training_config_from_dict(cfg_dict)
    model, opt, sched = port_train.build_trainer(
        cfg, "cpu", num_training_steps=STEPS, params=state_dict_from_jax_params(params0)
    )
    assert isinstance(opt, port_train.AdamW)
    phist = []
    for i in range(STEPS):
        phist.append(port_train.train_step(model, opt, sched, _port_batch(batches[i % 2]),
                                           clip=cfg.clip))
        if i == 2:  # the moments survive a checkpoint round trip
            from mca_tpu_torch import checkpoint

            checkpoint.Checkpointer().save_state(
                {"model": model.state_dict(), "optimizer": opt.state_dict(),
                 "schedule": sched.state_dict(), "step": 3, "epoch": 0}, tmp_path)
            saved = checkpoint.load_state(tmp_path)
            model, opt, sched = port_train.build_trainer(cfg, "cpu", num_training_steps=STEPS,
                                                         params=saved["model"])
            opt.load_state_dict(saved["optimizer"])
            sched.load_state_dict(saved["schedule"])
            for st, want in zip(opt.state.values(), saved["optimizer"]["state"].values()):
                assert st["exp_avg"].dtype == torch.bfloat16
                assert torch.equal(st["exp_avg"], want["exp_avg"])
    moments = [t for st in opt.state.values() for k, t in st.items() if k != "step"]
    assert moments and all(t.dtype == torch.bfloat16 for t in moments)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    for i, (p, j) in enumerate(zip(phist, jhist)):
        # the same tolerance as the fp32 trajectory: both round the same
        # fp32 moments to bf16, so they part only where the fp32 values
        # straddle a rounding boundary
        for k in ("total_loss", "fcl_loss", "no-fcl_loss", "grad_norm", "param_norm"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-4, err_msg=f"step {i} {k}")


def test_bf16_adamw_moves_like_fp32_adamw():
    """With fp32 storage the optax-semantics AdamW is torch's AdamW to
    rounding (the fp32 route keeps torch's, unchanged)."""
    torch.manual_seed(0)
    p0 = torch.randn(64, 32)
    a = torch.nn.Parameter(p0.clone())
    b = torch.nn.Parameter(p0.clone())
    opt_a = torch.optim.AdamW([a], lr=1e-2, weight_decay=0.01)
    opt_b = port_train.AdamW([b], lr=1e-2, moment_dtype=torch.float32)
    for _ in range(5):
        g = torch.randn(64, 32)
        a.grad, b.grad = g.clone(), g.clone()
        opt_a.step()
        opt_b.step()
    torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
