"""The port's pretraining run against the JAX package's, and ``remat``.

Whole run: the tiny TCGA config (4 tabular modalities of widths
12/8/10/6, dim 32, depth 2, the flash path) on a 40-row ``save_to_disk``
dataset, split 0.2 (4 steps an epoch), 2 epochs with an eval pass after
each.  ``mca_tpu.train.train`` runs it; the port's ``train`` runs it
from the initial weights the JAX run draws (``init_state`` with
``config.seed`` on ``train_dl.first_batch()``), and the two
``metrics.jsonl`` and final models must agree at fp32.

``remat``: the recomputing model gives the plain model's loss and
gradients, the flash backward reads the recomputed ``out`` and ``lse``,
and the flash forward runs twice a block.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml

from mca_tpu import checkpoint as jax_checkpoint
from mca_tpu import train as jax_train
from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.dataset import BatchedLoader as JaxLoader
from mca_tpu.data.dataset import setup_data as jax_setup_data
from mca_tpu.data.synthetic import make_tcga_like, tiny_config, to_hf_dataset
from mca_tpu.models import build_model as jax_build_model
from mca_tpu_torch import checkpoint
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import get_model_config, training_config_from_dict
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.interop import state_dict_from_jax_params
from mca_tpu_torch.models import build_model
from mca_tpu_torch.ops import flash_attention as flash

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for these tiny shapes: the suite runs several
    pytest workers on shared cores, where per-worker thread pools
    oversubscribe them and slow every small op many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(ds_path, **overrides):
    return tiny_config("tcga", widths=WIDTHS, batch_size=8, **{
        "epochs": 2, "split": 0.2, "attention_impl": "pallas", "dataset": ds_path,
        **overrides,
    })


@pytest.fixture(scope="module")
def ds_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ds") / "ds")
    to_hf_dataset(make_tcga_like(40, widths=WIDTHS, p_missing=0.2, seed=0)).save_to_disk(path)
    return path


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_run_matches_jax(monkeypatch, ds_path, tmp_path):
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    cfg_dict = _cfg_dict(ds_path, mesh_data=1)
    jcfg = jax_config(cfg_dict)
    jcfg.output_dir = str(tmp_path / "jax")
    # the initial weights as mca_tpu.train.train draws them
    data = jax_setup_data(jcfg.dataset, split=jcfg.split, ds_seed=jcfg.ds_seed)
    train_dl = JaxLoader(data["train"], JaxCollator(jcfg.modality_config.to_plain()),
                         jcfg.batch_size, shuffle=True, seed=jcfg.seed)
    jmodel = jax_build_model(jax_model_config(jcfg))
    tx = jax_train.make_optimizer(jcfg, jcfg.epochs * len(train_dl))
    state = jax_train.init_state(jmodel, tx, train_dl.first_batch(), jcfg.seed)
    params0 = state_dict_from_jax_params(jax.tree.map(np.asarray, state["params"]))
    jax_train.train(jcfg)

    pcfg = training_config_from_dict(cfg_dict)
    pcfg.output_dir = str(tmp_path / "port")
    assert port_train.train(pcfg, device="cpu", params=params0) == pcfg.output_dir

    want, got = _records(jcfg.output_dir), _records(pcfg.output_dir)
    assert [r["step"] for r in got] == [r["step"] for r in want]
    assert sum("total_loss" in r for r in got) == 8
    assert sum("val_epoch_total_loss" in r for r in got) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys(), g.keys() ^ w.keys()
        for k, v in w.items():
            if k in ("time", "tokens_per_sec"):
                continue
            if isinstance(v, float) and np.isnan(v):
                assert np.isnan(g[k]), (w["step"], k)
            elif k == "total_loss" or k.startswith("val_epoch_"):
                # fp32 both sides, sums in another order, through AdamW's
                # normalised updates for 8 steps: 1e-4 relative; the floor
                # is for the normalised uniformities near 0, which come
                # from 2 - 2 cos(x, y) of nearly parallel embeddings and
                # keep ~1e-7 of absolute rounding
                np.testing.assert_allclose(g[k], v, rtol=1e-4, atol=1e-6,
                                           err_msg=f"step {w['step']} {k}")
            elif k in ("step", "epoch", "lr"):
                np.testing.assert_allclose(g[k], v, rtol=1e-6, err_msg=k)
    want_final = state_dict_from_jax_params(
        jax.tree.map(np.asarray, jax_checkpoint.load_params(jcfg.output_dir))
    )
    got_final = checkpoint.load_params(pcfg.output_dir)
    for k, v in want_final.items():
        np.testing.assert_allclose(got_final[k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(v.abs().max()), err_msg=k)


def test_cli_trains_from_a_dataset_and_restarts(ds_path, tmp_path):
    out = str(tmp_path / "out")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg_dict(ds_path, output_dir=out)))
    port_train.main([str(cfg_path), "--device", "cpu"])
    for name in ("metrics.jsonl", "config.yaml", "model.safetensors"):
        assert os.path.isfile(os.path.join(out, name)), name
    for d in ("0", "1"):
        assert checkpoint.load_state(os.path.join(out, d))["step"] == 4 * (int(d) + 1)
    assert os.path.isfile(os.path.join(out, "model", "model.pt"))
    steps = [r for r in _records(out) if "total_loss" in r]
    assert [r["step"] for r in steps] == list(range(1, 9))
    assert [r["epoch"] for r in steps] == [0] * 4 + [1] * 4
    assert all("tokens_per_sec" in r for r in steps)

    # restart: from the epoch-0 checkpoint, epoch 1 again, the same losses
    out2 = str(tmp_path / "out2")
    cfg_path.write_text(yaml.safe_dump(_cfg_dict(ds_path, output_dir=out2,
                                                 restart=os.path.join(out, "0"))))
    port_train.main([str(cfg_path), "--device", "cpu"])
    again = [r for r in _records(out2) if "total_loss" in r]
    assert [(r["step"], r["total_loss"]) for r in again] == [
        (r["step"], r["total_loss"]) for r in steps[4:]
    ]


def test_cli_names_an_output_dir_when_none_is_set(ds_path, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(_cfg_dict(ds_path, epochs=1, run_eval_loop=False)))
    port_train.main([str(cfg_path), "--device", "cpu"])
    (out,) = [d for d in os.listdir(tmp_path) if d.startswith("training_output_")]
    assert os.path.isfile(tmp_path / out / "config.yaml")
    assert os.path.isfile(tmp_path / out / "model.safetensors")


def _model_and_batch(remat):
    cfg = training_config_from_dict(tiny_config("tcga", widths=WIDTHS, batch_size=8,
                                                attention_impl="pallas", remat=remat))
    model = build_model(get_model_config(cfg), fused_ff=False)
    model.init_weights(torch.Generator().manual_seed(0))
    rows = make_tcga_like(8, widths=WIDTHS, p_missing=0.25, seed=1)
    batch = port_train.to_device(MultimodalCollator(cfg.modality_config.to_plain())(rows), "cpu")
    return model, batch


def _loss_and_grads(model, batch):
    out = model(batch, no_loss=False)
    out["loss"].backward()
    return out["loss"].detach(), {n: p.grad for n, p in model.named_parameters()}


def test_remat_gives_the_plain_loss_and_gradients():
    plain, batch = _model_and_batch(False)
    remat, _ = _model_and_batch(True)
    assert remat.remat and not plain.remat
    remat.load_state_dict(plain.state_dict())
    loss_p, grads_p = _loss_and_grads(plain, batch)
    loss_r, grads_r = _loss_and_grads(remat, batch)
    torch.testing.assert_close(loss_r, loss_p, rtol=1e-6, atol=0)
    # no gradient goes missing through the recomputed blocks (the train
    # step zero-fills None gradients, which would hide it)
    assert {n for n, g in grads_r.items() if g is None} == {
        n for n, g in grads_p.items() if g is None
    }
    assert all(grads_r[f"layers.{i}.attn.to_q.weight"] is not None for i in range(2))
    for n, g in grads_p.items():
        if g is not None:
            torch.testing.assert_close(grads_r[n], g, rtol=1e-6, atol=1e-6 * float(g.abs().max()),
                                       msg=n)


def test_remat_backward_reads_the_recomputed_attention(monkeypatch):
    """Each block's flash forward runs again in the backward, and the
    flash backward takes that recompute's ``out`` and ``lse``, not
    stale ones."""
    model, batch = _model_and_batch(True)
    outs, seen = [], []
    real_fwd, real_bwd = flash._forward, flash.flash_attention_backward

    def fwd(*args):
        res = real_fwd(*args)
        outs.append((torch.is_grad_enabled(), res))  # holds them: no address reuse
        return res

    def bwd(q, k, v, mask, pad, out, lse, *rest):
        seen.append((out, lse))
        return real_bwd(q, k, v, mask, pad, out, lse, *rest)

    monkeypatch.setattr(flash, "_forward", fwd)
    monkeypatch.setattr(flash, "flash_attention_backward", bwd)
    out = model(batch, no_loss=False)
    first = len(outs)
    out["loss"].backward()
    depth = len(model.layers)
    assert first == depth and len(outs) == 2 * depth and len(seen) == depth
    recomputed = {r[0].data_ptr(): r for _, r in outs[first:]}
    for o, lse in seen:
        assert o.data_ptr() in recomputed and recomputed[o.data_ptr()][1].data_ptr() == lse.data_ptr()
    assert not {r[0].data_ptr() for _, r in outs[:first]} & recomputed.keys()


def test_remat_is_off_without_gradients():
    model, batch = _model_and_batch(True)
    calls = []
    real = flash._forward
    flash._forward = lambda *a: (calls.append(1), real(*a))[1]
    try:
        with torch.no_grad():
            model(batch, no_loss=False)
    finally:
        flash._forward = real
    assert len(calls) == len(model.layers)
