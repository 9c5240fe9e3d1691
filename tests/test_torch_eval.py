"""The port's eval pass against the JAX package's.

``epoch_metrics`` (uniformity and alignment, raw and L2-normalised) on
random embeddings with one modality absent from every row, at fp32
rtol 1e-5; and ``run_eval_epoch`` on the tiny TCGA model with weights
carried from JAX: the same records, the same keys (``val_step_*``,
``val_epoch_*``, ``norm_`` variants, the reference's ``unformity``
spelling, none for the absent modality), the same values at fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.config import get_model_config as jax_model_config
from mca_tpu.config import training_config_from_dict as jax_config
from mca_tpu.data.collators import MultimodalCollator as JaxCollator
from mca_tpu.data.dataset import BatchedLoader as JaxLoader
from mca_tpu.data.synthetic import make_tcga_like, tiny_config
from mca_tpu.eval_metrics import epoch_metrics as jax_epoch_metrics
from mca_tpu.models import build_model as jax_build_model
from mca_tpu.parallel.mesh import make_mesh
from mca_tpu.train import eval_output_names, make_eval_step
from mca_tpu.train import run_eval_epoch as jax_run_eval_epoch
from mca_tpu_torch import eval_metrics
from mca_tpu_torch import train as port_train
from mca_tpu_torch.config import training_config_from_dict
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.data.dataset import BatchedLoader
from mca_tpu_torch.interop import state_dict_from_jax_params

WIDTHS = {"gene": 12, "protein": 8, "methylation": 10, "mirna": 6}
MASK_NAMES = ("gene", "methylation", "mirna", "protein")
EMB_NAMES = MASK_NAMES + ("fusion",)


def _chunks(seed=0, n_batches=3, bs=8, dim=16):
    """Per-batch ``[E, B, D]`` embeddings and ``[M, B]`` presence, with
    mirna absent everywhere and the other modalities partly present."""
    rng = np.random.default_rng(seed)
    emb = [rng.normal(size=(len(EMB_NAMES), bs, dim)).astype(np.float32)
           for _ in range(n_batches)]
    msk = []
    for _ in range(n_batches):
        m = rng.random((len(MASK_NAMES), bs)) < 0.7
        m[MASK_NAMES.index("mirna")] = False
        msk.append(m)
    return emb, msk


@pytest.mark.parametrize("seed", [0, 1])
def test_epoch_metrics_match_jax(seed):
    emb, msk = _chunks(seed)
    n = len(emb)
    _, _, junif, jalign, jcounts = jax.device_get(jax_epoch_metrics(
        tuple(jnp.asarray(e) for e in emb), tuple(jnp.asarray(m) for m in msk),
        tuple(jnp.zeros(()) for _ in range(n)), tuple(jnp.zeros((1,)) for _ in range(n)),
        emb_names=EMB_NAMES, mask_names=MASK_NAMES, fusion=True,
    ))
    unif, align, counts = eval_metrics.epoch_metrics(
        [torch.from_numpy(e) for e in emb], [torch.from_numpy(m) for m in msk],
        emb_names=EMB_NAMES, mask_names=MASK_NAMES, fusion=True,
    )
    assert unif.keys() == junif.keys() and align.keys() == jalign.keys()
    assert {k: int(v) for k, v in counts.items()} == {k: int(v) for k, v in jcounts.items()}
    assert int(counts["mirna"]) == 0
    # an absent modality's value is never logged (XLA flushes the 1e-38
    # floor to zero, so JAX reads -inf there): compare the present ones
    for got, want in ((unif, junif), (align, jalign)):
        for k in (k for k in want if jcounts[k] > 0):
            for variant in ("raw", "norm"):
                np.testing.assert_allclose(float(got[k][variant]), float(want[k][variant]),
                                           rtol=1e-5, err_msg=f"{k} {variant}")


@pytest.mark.parametrize("norm", [False, True])
def test_masked_metrics_match_a_loop(norm):
    """Uniformity and alignment against their definitions, pair by pair."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(7, 5))
    y = rng.normal(size=(7, 5))
    mask = np.array([1, 1, 0, 1, 1, 0, 1], bool)
    xs, ys = x, y
    if norm:
        xs = x / np.linalg.norm(x, axis=-1, keepdims=True)
        ys = y / np.linalg.norm(y, axis=-1, keepdims=True)
    idx = np.flatnonzero(mask)
    pairs = [np.exp(-2.0 * np.sum((xs[i] - xs[j]) ** 2)) for i in idx for j in idx if i < j]
    want_u = np.log(np.mean(pairs))
    want_a = np.mean([np.sum((xs[i] - ys[i]) ** 2) for i in idx])
    tx, ty, tm = (torch.from_numpy(a) for a in (x, y, mask))
    np.testing.assert_allclose(float(eval_metrics.masked_uniformity(tx, tm, norm=norm)),
                               want_u, rtol=1e-10)
    np.testing.assert_allclose(float(eval_metrics.masked_alignment(tx, ty, tm, norm=norm)),
                               want_a, rtol=1e-10)


class _Collect:
    def __init__(self):
        self.records = []

    def log(self, metrics, step=None):
        self.records.append({**metrics, "step": step})


def test_run_eval_epoch_matches_jax(monkeypatch):
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    cfg_dict = tiny_config("tcga", widths=WIDTHS, batch_size=8, attention_impl="pallas")
    rows = make_tcga_like(24, widths=WIDTHS, p_missing=0.25, seed=2)
    for r in rows:  # mirna absent from every row: no keys for it
        r["mirna"]["values"][:] = -10000.0
    jcfg = jax_config(cfg_dict)
    model_config = jax_model_config(jcfg)
    jmodel = jax_build_model(model_config)
    jdl = JaxLoader(rows, JaxCollator(jcfg.modality_config.to_plain()), 8)
    batch0 = jax.tree.map(jnp.asarray, jdl.first_batch())
    params = jax.jit(jmodel.init)(jax.random.key(0), batch0)
    names = eval_output_names(jmodel, model_config, params, batch0)
    jlog = _Collect()
    jax_run_eval_epoch(jcfg, model_config, (make_eval_step(jmodel, *names), None, names, 1),
                       params, jdl, make_mesh(1, 1), jlog, step=7)

    cfg = training_config_from_dict(cfg_dict)
    model = port_train.build_trainer(
        cfg, "cpu", params=state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    )[0]
    precs = []
    pdl = BatchedLoader(rows, MultimodalCollator(cfg.modality_config.to_plain()), 8)
    port_train.run_eval_epoch(model, pdl, lambda rec, at: precs.append({**rec, "step": at}),
                              7, torch.device("cpu"))
    assert model.training  # back in train mode
    assert len(precs) == len(jlog.records) == 4  # 3 batches, then the epoch
    for got, want in zip(precs, jlog.records):
        assert got.keys() == want.keys(), got.keys() ^ want.keys()
        for k, v in want.items():
            if np.isnan(v):
                assert np.isnan(got[k]), k
            else:
                # fp32 both sides, sums in another order
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    epoch = precs[-1]
    assert "val_epoch_unformity_avg" in epoch and "val_epoch_norm_alignment_avg" in epoch
    assert not any("mirna" in k for k in epoch if "uniformity" in k or "alignment" in k)
