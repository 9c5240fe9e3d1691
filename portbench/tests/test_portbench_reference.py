"""The plain reference against the program on the CPU, at tiny widths,
both in fp32: forward and losses, the gradient, one AdamW step, and the
serving outputs.  Only the tests import both."""

import numpy as np
import pytest
import torch

from portbench.data import make_rows, make_weights
from portbench.reference import train as rt
from portbench.reference.model import Layout, Reference, param_specs
from portbench.tests.conftest import tiny_config

CONFIGS = ["tiny_tab", "tiny_seq"]


def program_trainer(cfg, params):
    from mca_tpu_torch.config import training_config_from_dict
    from mca_tpu_torch.train import build_trainer

    return build_trainer(training_config_from_dict(dict(cfg, precision="fp32")), "cpu",
                         num_training_steps=100, params=params)


def program_batch(cfg, rows):
    from mca_tpu_torch.data.collators import MultimodalCollator
    from mca_tpu_torch.train import to_device

    return to_device(MultimodalCollator(cfg["modality_config"])(rows), "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_parameters_are_the_programs(name):
    cfg = tiny_config(name)
    model, _, _ = program_trainer(cfg, None)
    want = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert {n: s for n, s, _ in param_specs(cfg)} == want


@pytest.mark.parametrize("name", CONFIGS)
def test_masks_are_the_programs(name):
    cfg = tiny_config(name)
    model, _, _ = program_trainer(cfg, None)
    lay = Layout(cfg)
    assert np.array_equal(lay.attn_blocked, model.mask_set.attn_mask)
    assert np.array_equal(lay.pool_blocked, model.mask_set.pool_mask)
    assert lay.output_keys() == sorted(model.loss.output_keys())


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_and_losses(name):
    cfg = tiny_config(name)
    rows = make_rows(cfg, 8, seed=11, p_missing=0.3)
    params = make_weights(cfg, 12, "cpu")
    model, _, _ = program_trainer(cfg, params)
    out = model(program_batch(cfg, rows))
    ref = Reference(cfg)
    pooled, present = rt.pooled_all(ref, params, rows, 3, "cpu")
    losses = ref.losses(pooled, present, params["loss.loss_fn.logit_scale"])
    assert set(losses) == set(out["losses"])
    for k, v in losses.items():
        assert torch.allclose(out["losses"][k].float(), v, rtol=1e-5, atol=1e-6, equal_nan=True), k
    assert torch.allclose(out["loss"], ref.total(losses), rtol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_gradient_and_adamw_step(name):
    from mca_tpu_torch.train import train_step

    cfg = tiny_config(name)
    rows = make_rows(cfg, 8, seed=13, p_missing=0.3)
    params = make_weights(cfg, 14, "cpu")
    model, opt, sched = program_trainer(cfg, params)
    metrics = train_step(model, opt, sched, program_batch(cfg, rows), clip=float(cfg["clip"]))
    ref = rt.train_steps(cfg, params, [rows], 100, 3, "cpu")
    assert metrics["total_loss"] == pytest.approx(ref["losses"][0], rel=1e-5)
    for n, p in model.named_parameters():
        got = float(opt.state[p]["exp_avg"].norm()) / 0.1
        assert got == pytest.approx(ref["grad"][n], rel=1e-4, abs=1e-7), n
        moved = float((p.detach() - params[n]).norm())
        assert moved == pytest.approx(ref["change"][n], rel=1e-3, abs=1e-8), n


@pytest.mark.parametrize("name", CONFIGS)
def test_serving_outputs(name):
    from mca_tpu_torch.config import training_config_from_dict
    from mca_tpu_torch.serve import EmbeddingService

    cfg = tiny_config(name)
    rows = make_rows(cfg, 6, seed=15, p_missing=0.3)
    params = make_weights(cfg, 16, "cpu")
    svc = EmbeddingService(training_config_from_dict(dict(cfg, precision="fp32")),
                           params=params, max_batch=4, device="cpu")
    got = svc.embed(rows)
    ref = Reference(cfg)
    pooled, present = rt.pooled_all(ref, params, rows, 4, "cpu")
    for k, e in ref.embeddings(pooled).items():
        np.testing.assert_allclose(got["embeddings"][k], e.numpy(), rtol=1e-4, atol=1e-5)
    for m, p in present.items():
        np.testing.assert_array_equal(got["present"][m], p.numpy())


def test_missing_modality_rows():
    """A row with a modality missing: its tokens attend nothing (zero
    output), and its pooled token averages every key."""
    cfg = tiny_config("tiny_tab")
    rows = make_rows(cfg, 4, seed=17, p_missing=0.0)
    rows[1]["gene"]["values"][:] = -10000.0
    params = make_weights(cfg, 18, "cpu")
    model, _, _ = program_trainer(cfg, params)
    model.eval()
    with torch.no_grad():
        out = model(program_batch(cfg, rows), no_loss=True)
    pooled, present = rt.pooled_all(Reference(cfg), params, rows, 4, "cpu")
    assert not bool(present["gene"][1]) and bool(present["gene"][0])
    torch.testing.assert_close(out["gene"], pooled[:, 0], rtol=1e-4, atol=1e-5)
