"""The port's contrastive loss graph against the JAX package's
(``mca_tpu.losses``) on the same numpy embeddings and presence masks.

Covers the CLIP loss with and without a row mask, an empty mask (NaN),
the temperature clamp, and the whole ``MCAPretrainingLoss`` graph at the
TCGA layout (4 modalities, combos [4, 3, 2], FCL + bimodal + non-fusion
FCL) with one pair whose joint presence mask is empty, so its NaN must
be excluded from ``loss`` and zeroed in the aggregates.  fp32 both sides.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu import losses as jax_losses
from mca_tpu import masks as jax_masks
from mca_tpu_torch import losses as port_losses
from mca_tpu_torch import masks as port_masks

NAMES = ("gene", "protein", "methylation", "mirna")
# fp32 log-softmax of the same logits on both sides; the only difference
# is the summation order of the [B, D] x [D, B] products and the means
RTOL = 1e-6
# gradients sum B terms of those products once more
GRAD_RTOL = 1e-5


def _emb(rng, *shape):
    # moderate scale: raw dot products times the temperature (14.3) must
    # not saturate the fp32 softmax, or the comparison is of noise
    return (0.2 * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize(
    "mask", [None, np.array([1, 1, 0, 1, 0, 1], bool), np.zeros(6, bool)],
    ids=["no-mask", "mask", "empty-mask"],
)
@pytest.mark.parametrize("logit_scale", [jax_losses.LOGIT_SCALE_INIT, 10.0])
def test_clip_contrastive_loss_matches_jax(mask, logit_scale):
    rng = np.random.default_rng(0)
    a, b = _emb(rng, 6, 8), _emb(rng, 6, 8)
    want = float(
        jax_losses.clip_contrastive_loss(
            jnp.asarray(a), jnp.asarray(b), jnp.float32(logit_scale),
            mask=None if mask is None else jnp.asarray(mask),
        )
    )
    got = float(
        port_losses.clip_contrastive_loss(
            torch.from_numpy(a), torch.from_numpy(b),
            torch.tensor(logit_scale, dtype=torch.float32),
            mask=None if mask is None else torch.from_numpy(mask),
        )
    )
    if mask is not None and not mask.any():
        assert math.isnan(got) and math.isnan(want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL)


def test_logit_scale_bounds_match_jax():
    assert port_losses.LOGIT_SCALE_MIN == jax_losses.LOGIT_SCALE_MIN
    assert port_losses.LOGIT_SCALE_MAX == jax_losses.LOGIT_SCALE_MAX
    assert port_losses.LOGIT_SCALE_INIT == jax_losses.LOGIT_SCALE_INIT


def _case(seed, empty_pair):
    rng = np.random.default_rng(seed)
    combos = jax_masks.build_masks([4, 3, 5, 2], 22, [4, 3, 2], fcl=True).fusion_combos
    b, r, d = 6, len(NAMES) + len(combos), 16
    pooled = _emb(rng, b, r, d)
    present = {n: rng.random(b) < 0.7 for n in NAMES}
    for n in NAMES:
        present[n][0] = True  # sample 0 has every modality
    if empty_pair:
        # mirna missing from the whole batch: every pair with it is NaN
        present["mirna"][:] = False
    return pooled, present, combos


def _jax_out(pooled, present, combos, **kw):
    mod = jax_losses.MCAPretrainingLoss(
        modality_names=NAMES, do_fcl=True, fusion_combos=combos, **kw
    )
    masks = {k: jnp.asarray(v) for k, v in present.items()}
    params = mod.init(jax.random.key(0), jnp.asarray(pooled), masks)

    def loss_of(p, t):
        return mod.apply(p, t, masks)["loss"]

    out = mod.apply(params, jnp.asarray(pooled), masks)
    grads = jax.grad(loss_of, argnums=(0, 1))(params, jnp.asarray(pooled))
    return out, grads


@pytest.mark.parametrize("empty_pair", [False, True])
@pytest.mark.parametrize(
    "kw",
    [
        dict(bimodal_contrastive=True, non_fusion_fcl=True),
        dict(bimodal_contrastive=False, non_fusion_fcl=False),
    ],
    ids=["bimodal-nonfusionfcl", "modality-to-fusion"],
)
def test_pretraining_loss_graph_matches_jax(empty_pair, kw):
    pooled, present, combos = _case(1, empty_pair)
    assert combos == port_masks.build_masks(
        [4, 3, 5, 2], 22, [4, 3, 2], fcl=True
    ).fusion_combos
    jout, (jgp, jgt) = _jax_out(pooled, present, combos, **kw)

    mod = port_losses.MCAPretrainingLoss(NAMES, do_fcl=True, fusion_combos=combos, **kw)
    tokens = torch.from_numpy(pooled).requires_grad_(True)
    out = mod(tokens, {k: torch.from_numpy(v) for k, v in present.items()})
    out["loss"].backward()

    assert list(out["losses"]) == list(jout["losses"])
    for k, v in jout["losses"].items():
        got, want = float(out["losses"][k].detach()), float(v)
        if math.isnan(want):
            assert math.isnan(got), k
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=k)
    nan_pairs = [k for k, v in out["losses"].items() if math.isnan(float(v.detach()))]
    assert bool(nan_pairs) == empty_pair
    for k in ("loss", "fcl_loss", "no-fcl_loss"):
        got = float(out[k].detach())
        assert math.isfinite(got), k
        np.testing.assert_allclose(got, float(jout[k]), rtol=RTOL, err_msg=k)
    for k in set(jout) - {"losses", "loss", "fcl_loss", "no-fcl_loss"}:
        np.testing.assert_array_equal(out[k].detach().numpy(), np.asarray(jout[k]))
    # gradients: into the pooled tokens and the shared temperature
    np.testing.assert_allclose(
        tokens.grad.numpy(), np.asarray(jgt), rtol=GRAD_RTOL,
        atol=GRAD_RTOL * float(np.abs(jgt).max()),
    )
    np.testing.assert_allclose(
        float(mod.loss_fn.logit_scale.grad),
        float(jgp["params"]["logit_scale"]), rtol=GRAD_RTOL,
    )


def test_separate_modal_loss_fns_raises():
    with pytest.raises(NotImplementedError, match="separate_modal_loss_fns"):
        port_losses.MCAPretrainingLoss(NAMES, separate_modal_loss_fns=True)
