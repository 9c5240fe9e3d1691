"""The port's ``probe`` against ``mca_tpu.probe.probe``.

Both read the same embedding files, written by ``mca_tpu.infer.infer``
from the JAX MCA's ``init`` weights at the tiny TCGA shape (48 rows of 4
classes, split 0.25: 32 train and 8 eval rows after ``drop_last``).  The
JAX probe's initial head (captured where it calls ``ProbeHead.init``) is
carried into the port with ``probe_head_state_from_jax``, and both train
on the CPU; every JSONL record must agree.  The device loop
(``scan_epochs``) is held to the host loop on a full batch, as the JAX
package's own test holds its scanned loop.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mca_tpu import checkpoint as jax_checkpoint
from mca_tpu import infer as jax_infer
from mca_tpu import probe as jax_probe
from mca_tpu.config import get_cfg_defaults_embedding_eval as jax_probe_defaults
from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config, to_hf_dataset
from mca_tpu.models import build_model as jax_build_model
from mca_tpu_torch import probe
from mca_tpu_torch.config import get_cfg_defaults_embedding_eval
from mca_tpu_torch.interop import probe_head_state_from_jax

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


@pytest.fixture(scope="module")
def embedding_dir(tmp_path_factory):
    """The JAX package's six embedding files (dense attention: the
    files are the probe's data, whatever computed them)."""
    root = tmp_path_factory.mktemp("probe")
    rows = make_tcga_like(48, widths=WIDTHS, p_missing=0.2, seed=0, n_classes=4)
    to_hf_dataset(rows).save_to_disk(str(root / "ds"))
    cfg = jax_config(tiny_config("tcga", widths=WIDTHS, batch_size=8, split=0.25,
                                 precision="fp32", dataset=str(root / "ds")))
    batch = jax.tree.map(jnp.asarray, JaxCollator(cfg.modality_config.to_plain())(rows[:8]))
    params = jax.jit(jax_build_model(jax_model_config(cfg)).init)(jax.random.key(0), batch)
    jax_checkpoint.save_params(jax.tree.map(np.asarray, params), str(root / "model"))
    cfg.restart, cfg.output_dir = str(root / "model"), str(root / "emb")
    jax_infer.infer(cfg)
    return cfg.output_dir


def _settings(embedding_dir, out, **kw):
    return {"embedding_dir": embedding_dir, "output_dir": str(out), "epochs": 5, "lr": 1e-3,
            "num_warmup_steps": 2, "rank_metrics": False, "seed": 3, **kw}


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _run_jax(settings, monkeypatch):
    """``mca_tpu.probe.probe`` and the head weights it started from."""
    captured = []
    init = jax_probe.ProbeHead.init

    def capture(self, *args, **kwargs):
        captured.append(jax.tree.map(np.asarray, init(self, *args, **kwargs)))
        return captured[-1]

    monkeypatch.setattr(jax_probe.ProbeHead, "init", capture)
    cfg = jax_probe_defaults()
    cfg.update(settings)
    final = jax_probe.probe(cfg)
    return final, _records(settings["output_dir"]), captured[0] if captured else None


def _run_port(settings, params=None):
    cfg = get_cfg_defaults_embedding_eval()
    cfg.update(settings)
    final = probe.probe(cfg, device="cpu", params=params)
    return final, _records(settings["output_dir"])


def _assert_records_match(port, ref, rename=None):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        b = {(rename or {}).get(k, k): v for k, v in b.items() if k != "time"}
        a = {k: v for k, v in a.items() if k != "time"}
        assert a.keys() == b.keys(), a.keys() ^ b.keys()
        for k, v in b.items():
            # fp32 both sides, sums in another order: 1e-4 relative, with
            # an absolute floor for values near zero
            np.testing.assert_allclose(a[k], v, rtol=1e-4, atol=1e-6, err_msg=k)


CASES = {
    # loss, head, task, batch: full batch (32 rows), or 12 (a remainder of 8)
    "bce_linear": dict(loss_type="BCE", model_type="linear", task=-1, batch_size=1024,
                       rank_metrics=True),
    "bce_mlp_minibatch": dict(loss_type="BCE", model_type="mlp", task=-1, batch_size=12),
    "ce_onehot_linear": dict(loss_type="CE", model_type="linear", task=-1, batch_size=1024),
    "ce_binary_mlp_minibatch": dict(loss_type="CE", model_type="mlp", task=0, batch_size=12,
                                    hidden_size=16),
    "l1_linear_minibatch": dict(loss_type="L1", model_type="linear", task=0, batch_size=12),
    "mse_mlp": dict(loss_type="MSE", model_type="mlp", task=0, batch_size=1024,
                    hidden_size=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_probe_matches_jax(embedding_dir, tmp_path, monkeypatch, case):
    jfinal, jrecs, head = _run_jax(_settings(embedding_dir, tmp_path / "jax", **CASES[case]),
                                   monkeypatch)
    final, recs = _run_port(_settings(embedding_dir, tmp_path / "port", **CASES[case]),
                            probe_head_state_from_jax(head))
    _assert_records_match(recs, jrecs)
    assert [r.get("step") for r in recs if "train_loss" in r] == list(range(5))
    _assert_records_match([final], [jfinal])
    if CASES[case].get("rank_metrics"):
        # 4 modalities' rank rows, then the fusion uniformity row: the
        # same numpy code on the same files gives the same numbers
        assert len(recs) == 5 + 5
        for a, b in zip(recs[:5], jrecs[:5]):
            assert {k: v for k, v in a.items() if k != "time"} == {
                k: v for k, v in b.items() if k != "time"}


@pytest.mark.parametrize("loss_type", ["CE", "L1"])
def test_ridge_matches_jax(embedding_dir, tmp_path, monkeypatch, loss_type):
    kw = dict(loss_type=loss_type, model_type="ridge", task=-1 if loss_type == "CE" else 0)
    jfinal, jrecs, _ = _run_jax(_settings(embedding_dir, tmp_path / "jax", **kw), monkeypatch)
    final, recs = _run_port(_settings(embedding_dir, tmp_path / "port", **kw))
    assert len(recs) == 1
    for k, v in jfinal.items():
        # the float64 solve and the metrics are the same numpy code; the
        # losses are fp32 means taken by each framework
        if k.endswith("_loss"):
            np.testing.assert_allclose(final[k], v, rtol=1e-6, err_msg=k)
        else:
            assert final[k] == v or (np.isnan(final[k]) and np.isnan(v)), k


def test_combo_readout_names_its_uniformity(embedding_dir, tmp_path, monkeypatch):
    """``embedding_key: "combo:0,1"`` (EAO's readout): the port names the
    uniformity records after the combo, where the JAX package writes
    ``*_uniformity_fusion``; the values and every other record agree."""
    kw = dict(loss_type="BCE", task=-1, batch_size=1024, rank_metrics=True,
              embedding_key="combo:0,1")
    _, jrecs, head = _run_jax(_settings(embedding_dir, tmp_path / "jax", **kw), monkeypatch)
    _, recs = _run_port(_settings(embedding_dir, tmp_path / "port", **kw),
                        probe_head_state_from_jax(head))
    assert "train_uniformity_combo:0,1" in recs[4] and "test_uniformity_combo:0,1" in recs[4]
    _assert_records_match(recs, jrecs, rename={
        "train_uniformity_fusion": "train_uniformity_combo:0,1",
        "test_uniformity_fusion": "test_uniformity_combo:0,1"})


def test_device_loop_matches_host_loop_on_a_full_batch(embedding_dir, tmp_path):
    """Order cannot matter on a full batch: the two loops differ only in
    the order of their sums (the JAX package's pin, rtol 2e-4)."""
    kw = dict(loss_type="BCE", task=-1, batch_size=4096, epochs=12)
    host, host_recs = _run_port(_settings(embedding_dir, tmp_path / "host", **kw))
    dev, dev_recs = _run_port(_settings(embedding_dir, tmp_path / "dev", scan_epochs=True,
                                        scan_epochs_chunk=5, **kw))
    assert [r["step"] for r in dev_recs] == list(range(12))
    for key in ("train_loss", "eval_loss", "eval_f1", "eval_auroc", "param_norm", "grad_norm",
                "train_auroc", "lr"):
        np.testing.assert_allclose(dev[key], host[key], rtol=2e-4, atol=1e-6, err_msg=key)
    for a, b in zip(dev_recs, host_recs):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=2e-4)


def test_device_loop_minibatch_ce(embedding_dir, tmp_path):
    """A mini-batch CE device-loop run (32 rows in batches of 12: a
    remainder batch padded with rows of weight zero), records thinned by
    ``metrics_every`` with the last epoch always kept."""
    kw = dict(loss_type="CE", task=-1, batch_size=12, epochs=10, scan_epochs=True,
              scan_epochs_chunk=4, metrics_every=3)
    final, recs = _run_port(_settings(embedding_dir, tmp_path / "dev", **kw))
    assert [r["step"] for r in recs] == [2, 5, 8, 9]
    for r in recs:
        assert all(np.isfinite(r[k]) for k in ("train_loss", "eval_loss", "param_norm",
                                               "grad_norm", "train_accuracy")), r
        assert 0.0 <= r["eval_accuracy"] <= 1.0
    assert final == {k: v for k, v in recs[-1].items() if k not in ("step", "time")}


class _InOrder:
    """A stand-in for ``np.random.default_rng(seed)`` whose every
    permutation is the identity."""

    def __init__(self, seed=None):
        pass

    def permutation(self, n):
        return np.arange(n)


@pytest.mark.parametrize("loss_type,model_type", [("BCE", "linear"), ("CE", "mlp")])
def test_device_loop_remainder_matches_host_loop(embedding_dir, tmp_path, monkeypatch,
                                                 loss_type, model_type):
    """With both loops' orders pinned to the identity, a mini-batch run
    (32 rows in batches of 12: the device loop pads the remainder batch
    of 8 with 4 rows of weight zero) gives the host loop's records: the
    padded rows change neither the loss nor the gradient, and the train
    metrics read only the live rows."""
    monkeypatch.setattr(probe.np.random, "default_rng", _InOrder)
    monkeypatch.setattr(probe.torch, "randperm",
                        lambda n, generator=None, device=None: torch.arange(n, device=device))
    kw = dict(loss_type=loss_type, model_type=model_type, task=-1, batch_size=12, epochs=6,
              hidden_size=16)
    _, host_recs = _run_port(_settings(embedding_dir, tmp_path / "host", **kw))
    _, dev_recs = _run_port(_settings(embedding_dir, tmp_path / "dev", scan_epochs=True,
                                      scan_epochs_chunk=4, **kw))
    assert len(dev_recs) == len(host_recs) == 6
    for a, b in zip(dev_recs, host_recs):
        assert a.keys() == b.keys()
        for k in b:
            if k != "time":
                np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-6, err_msg=k)


def test_initial_head_follows_seed_and_flax_init():
    a = probe.ProbeHead(32, 4).init_weights(torch.Generator().manual_seed(3))
    b = probe.ProbeHead(32, 4).init_weights(torch.Generator().manual_seed(3))
    assert torch.equal(a.dense_0.weight, b.dense_0.weight)
    assert float(a.dense_0.weight.detach().abs().max()) <= 32 ** -0.5
    assert not a.dense_0.bias.any()
    mlp = probe.ProbeHead(32, 2, "mlp", hidden_size=16)
    assert [n for n, _ in mlp.named_parameters()] == [
        "dense_0.weight", "dense_0.bias", "dense_1.weight", "dense_1.bias"]


def test_cli_on_the_cpu(embedding_dir, tmp_path):
    settings = _settings(embedding_dir, tmp_path / "cli", loss_type="BCE", task=-1, epochs=2)
    (tmp_path / "p.yaml").write_text(yaml.safe_dump(settings))
    probe.main([str(tmp_path / "p.yaml"), "--device", "cpu"])
    recs = _records(tmp_path / "cli")
    assert [r["step"] for r in recs] == [0, 1]
    assert os.path.exists(tmp_path / "cli" / "config.yaml")
