"""The port's ``infer`` against ``mca_tpu.infer.infer``.

One 48-row ``save_to_disk`` dataset at the tiny TCGA shape (widths
12/8/10/6, split 0.25, batch 8: 4 train and 1 eval batch a split after
``drop_last``).  For each family (MCA, MMA/Zorro, ``no_fusion``, MCA with
``mean_pool``, EAO) the JAX model's ``init`` weights are saved by each
package's checkpoint code (``mca_tpu.checkpoint.save_params`` and, carried
with ``state_dict_from_jax_params``, ``mca_tpu_torch.checkpoint.save_params``)
and each package's ``infer`` writes its six files from its own
directory.  The port runs on the CPU through the plain versions of its
kernels (the fused feed-forward's too, as on the card); the JAX package
runs its attention as ``JAX_IMPL`` says, and its feed-forward as
``mca_tpu.infer.main`` sets it (``MCA_FUSED_FF=auto``: the XLA chain
off a TPU).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mca_tpu import checkpoint as jax_checkpoint
from mca_tpu import infer as jax_infer
from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.synthetic import make_tcga_like, tiny_config, to_hf_dataset
from mca_tpu.models import build_model as jax_build_model
from mca_tpu_torch import checkpoint, infer
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.interop import state_dict_from_jax_params

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
EAO_KW = dict(eao=True, no_fusion=True, mean_pool=True, num_fusion_tokens=0,
              fusion_combos=[2], fcl_root=[0, 1])
FAMILIES = {
    "mca": {},
    "mma_zorro": dict(zorro=True),
    "no_fusion": dict(no_fusion=True, fcl=False),
    "mean_pool": dict(mean_pool=True, zorro=True),
    "eao": EAO_KW,
}
# the JAX package's attention: its flash kernel in interpret mode where
# the attentive pool reads padded rows (a missing modality's return
# token averages every row, dead ones included, which flash leaves 0
# and dense attention fills), else its dense plain reference, which
# compiles faster
JAX_IMPL = {"mca": "pallas", "mma_zorro": "pallas", "no_fusion": "pallas",
            "mean_pool": "dense", "eao": "dense"}
FILES = [f"{s}_{k}" for s in ("train", "eval") for k in ("embeddings", "masks", "labels")]


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
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("infer")
    rows = make_tcga_like(48, widths=WIDTHS, p_missing=0.2, seed=0, n_classes=4)
    to_hf_dataset(rows).save_to_disk(str(root / "ds"))
    return root


def _cfg_dict(root, family, impl="pallas", **overrides):
    return tiny_config("tcga", widths=WIDTHS, batch_size=8, split=0.25, attention_impl=impl,
                       dataset=str(root / "ds"),
                       **{"precision": "fp32", **FAMILIES[family], **overrides})


@functools.lru_cache(maxsize=None)
def _weights(root, family):
    """The JAX model's init weights, saved by each package: ``(jax model
    dir, port model dir)``; once per module's ``root``."""
    jcfg = jax_config(_cfg_dict(root, family, "dense"))  # the same tree either way
    rows = make_tcga_like(8, widths=WIDTHS, p_missing=0.2, seed=5, n_classes=4)
    batch = jax.tree.map(jnp.asarray, JaxCollator(jcfg.modality_config.to_plain())(rows))
    params = jax.jit(jax_build_model(jax_model_config(jcfg)).init)(jax.random.key(0), batch)
    params = jax.tree.map(np.asarray, params)
    jdir, pdir = root / f"{family}_jax_model", root / f"{family}_port_model"
    jax_checkpoint.save_params(params, str(jdir))
    checkpoint.save_params(state_dict_from_jax_params(params), str(pdir))
    return str(jdir), str(pdir)


def _run_jax(root, family, restart, out, monkeypatch, **overrides):
    # as mca_tpu.infer.main sets it (fused on a TPU, the XLA chain here)
    monkeypatch.setenv("MCA_FUSED_FF", "auto")
    cfg = jax_config(_cfg_dict(root, family, JAX_IMPL[family], **overrides))
    cfg.restart, cfg.output_dir = restart, str(out)
    jax_infer.infer(cfg)
    return str(out)


def _run_port(root, family, restart, out, **overrides):
    cfg = training_config_from_dict(_cfg_dict(root, family, **overrides))
    cfg.restart, cfg.output_dir = restart, str(out)
    return infer.infer(cfg, device="cpu")


def _read(directory, loader=infer):
    return {
        f: (loader.load_label_file if f.endswith("labels") else loader.load_embedding_file)(
            os.path.join(directory, f))
        for f in FILES
    }


def _assert_files_match(port, ref, rtol, atol):
    for f in FILES:
        a, b = port[f], ref[f]
        if f.endswith("labels"):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            continue
        assert list(a) == list(b), (f, list(a), list(b))  # keys, their types and order
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (f, k)
            if f.endswith("masks"):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{f} {k}")
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, atol=atol, err_msg=f"{f} {k}")


@pytest.fixture(scope="module")
def outputs(root):
    """``family -> (JAX output dir, port output dir)``, each run once."""
    cache = {}
    with pytest.MonkeyPatch.context() as mp:
        def get(family):
            if family not in cache:
                jdir, pdir = _weights(root, family)
                cache[family] = (_run_jax(root, family, jdir, root / f"{family}_jax_out", mp),
                                 _run_port(root, family, pdir, root / f"{family}_port_out"))
            return cache[family]

        yield get


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_infer_matches_jax(outputs, family):
    jout, pout = outputs(family)
    port = _read(pout)
    # fp32 both sides, sums in another order
    _assert_files_match(port, _read(jout), rtol=1e-4, atol=1e-5)
    emb = port["train_embeddings"]
    n_keys = {"mca": 4 + 11 + 1, "eao": 4 + 6, "no_fusion": 4}.get(family, 4 + 1)
    assert len(emb) == n_keys and all(v.shape == (32, 32) for v in emb.values())
    assert port["eval_labels"].shape == (8, 4) and len(port["eval_masks"]) == 4
    assert any(isinstance(k, frozenset) for k in emb) == (family in ("mca", "eao"))
    assert ("fusion" in emb) == (family not in ("eao", "no_fusion"))


def test_infer_bf16_matches_jax(root, monkeypatch):
    """bf16 blocks: both round activations to bf16 (8 significant bits)
    at different places; through two blocks the embeddings agree within
    2e-2."""
    jdir, pdir = _weights(root, "mca")
    ref = _read(_run_jax(root, "mca", jdir, root / "bf16_jax", monkeypatch, precision="bf16"))
    port = _read(_run_port(root, "mca", pdir, root / "bf16_port", precision="bf16"))
    _assert_files_match(port, ref, rtol=2e-2, atol=2e-2)


def test_state_and_model_directories_give_the_same_files(root):
    _, pdir = _weights(root, "mca")
    sd = checkpoint.load_params(pdir)
    state_dir = root / "mca_state"
    checkpoint.Checkpointer().save_state(
        {"model": sd, "optimizer": {}, "schedule": {}, "step": 8, "epoch": 1}, str(state_dir))
    a = _read(_run_port(root, "mca", pdir, root / "from_model"))
    b = _read(_run_port(root, "mca", str(state_dir), root / "from_state"))
    for f in FILES:
        if f.endswith("labels"):
            assert torch.equal(torch.from_numpy(a[f]), torch.from_numpy(b[f]))
        else:
            assert list(a[f]) == list(b[f])
            assert all(np.array_equal(a[f][k], b[f][k]) for k in a[f]), f


def test_each_package_reads_the_others_files(outputs):
    for directory in outputs("mca"):
        a, b = _read(directory, infer), _read(directory, jax_infer)
        for f in FILES:
            if f.endswith("labels"):
                np.testing.assert_array_equal(a[f], b[f])
            else:
                assert list(a[f]) == list(b[f])
                assert all(np.array_equal(a[f][k], b[f][k]) for k in a[f])


def test_npz_files_are_read(tmp_path):
    emb = {"gene": np.ones((3, 2), np.float32), "fusion": np.zeros((3, 2), np.float32)}
    np.savez(tmp_path / "e.npz", **emb)
    np.savez(tmp_path / "l.npz", labels=np.arange(3))
    got = infer.load_embedding_file(str(tmp_path / "e"))
    assert list(got) == ["gene", "fusion"] and np.array_equal(got["gene"], emb["gene"])
    np.testing.assert_array_equal(infer.load_label_file(str(tmp_path / "l")), np.arange(3))


def test_helpers_match_jax():
    assert infer.combo_str_to_frozenset("combo:0,2,3") == jax_infer.combo_str_to_frozenset(
        "combo:0,2,3") == frozenset({0, 2, 3})
    out = {"gene": 0, "combo:0,1": 0, "fusion": 0, "loss": 0, "losses": 0, "fcl_loss": 0,
           "no-fcl_loss": 0, "modality_sample_mask": {"protein": 0, "gene": 0}}
    assert infer.split_output_keys(out) == tuple(map(list, jax_infer.split_output_keys(out)))


def test_infer_needs_restart(root):
    cfg = training_config_from_dict(_cfg_dict(root, "mca"))
    cfg.output_dir = str(root / "no_restart")
    with pytest.raises(ValueError, match="restart"):
        infer.infer(cfg, device="cpu")


def test_cli_on_the_cpu(root, tmp_path):
    _, pdir = _weights(root, "mca")
    cfg = {**_cfg_dict(root, "mca"), "restart": pdir, "output_dir": str(tmp_path / "cli")}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    infer.main([str(tmp_path / "cfg.yaml"), "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "cli")) == sorted(
        [f + ".pt" for f in FILES] + ["config.yaml"])
    infer.main([str(tmp_path / "cfg.yaml"), "--device", "cpu", "--synthetic", "48"])
    # 48 synthetic rows of 5 classes: 36 train rows (4 batches), 12 eval (1)
    assert infer.load_label_file(str(tmp_path / "cli" / "eval_labels")).shape == (8, 5)
    assert infer.load_embedding_file(str(tmp_path / "cli" / "train_embeddings"))[
        "fusion"].shape == (32, 32)
