"""The port's contrastive loss graph against the JAX package's
(``mca_tpu.losses``) on the same numpy embeddings and presence masks.

Covers the CLIP loss with and without a row mask, an empty mask (NaN),
the temperature clamp, and the whole ``MCAPretrainingLoss`` graph at the
TCGA layout (4 modalities, combos [4, 3, 2], FCL + bimodal + non-fusion
FCL) with one pair whose joint presence mask is empty, so its NaN must
be excluded from ``loss`` and zeroed in the aggregates.  fp32 both sides.

Then the batched graph against a loop of ``clip_contrastive_loss`` over
the same losses at six layouts, and the ops it dispatches (as many for 60
losses as for 14).
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


def _separate_case():
    """JAX's loss with one temperature per pair and combo, each set apart
    from the others, and the port's module carrying them."""
    from mca_tpu_torch.interop import state_dict_from_jax_params

    pooled, present, combos = _case(2, False)
    kw = dict(bimodal_contrastive=True, non_fusion_fcl=True, separate_modal_loss_fns=True)
    mod = jax_losses.MCAPretrainingLoss(modality_names=NAMES, do_fcl=True,
                                        fusion_combos=combos, **kw)
    masks = {k: jnp.asarray(v) for k, v in present.items()}
    params = mod.init(jax.random.key(0), jnp.asarray(pooled), masks)
    names = list(params["params"])
    params = {"params": {n: jnp.float32(1.0 + 0.25 * i) for i, n in enumerate(names)}}
    jout = mod.apply(params, jnp.asarray(pooled), masks)
    jgrads = jax.grad(lambda p: mod.apply(p, jnp.asarray(pooled), masks)["loss"])(params)
    port = port_losses.MCAPretrainingLoss(NAMES, do_fcl=True, fusion_combos=combos, **kw)
    sd = state_dict_from_jax_params({"params": {"loss": jax.tree.map(np.asarray,
                                                                      params["params"])}})
    port.load_state_dict({k[len("loss."):]: v for k, v in sd.items()}, strict=True)
    return port, pooled, present, names, jout, jgrads


def test_separate_modal_loss_fns_raises():
    """``separate_modal_loss_fns`` no longer raises: the port declares
    JAX's temperatures (one per pair and per FCL combo, in JAX's order),
    and with each set to its own value the losses and each temperature's
    gradient equal JAX's."""
    port, pooled, present, names, jout, jgrads = _separate_case()
    assert [n for n, _ in port.named_parameters()] == names
    assert all(n.startswith("logit_scale_") for n in names) and len(names) > 10
    out = port(torch.from_numpy(pooled), {k: torch.from_numpy(v) for k, v in present.items()})
    assert list(out["losses"]) == list(jout["losses"])
    for k, v in jout["losses"].items():
        np.testing.assert_allclose(float(out["losses"][k].detach()), float(v), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(out["loss"].detach()), float(jout["loss"]), rtol=RTOL)
    out["loss"].backward()
    for n, p in port.named_parameters():
        np.testing.assert_allclose(float(p.grad), float(jgrads["params"][n]),
                                   rtol=GRAD_RTOL, atol=1e-9, err_msg=n)


def test_separate_modal_loss_fns_carry_and_clamp():
    """The JAX tree's ``loss/logit_scale_{name}`` carry to the port's
    ``loss.logit_scale_{name}``; the training step's clamp and the
    model's initialiser reach every one of them."""
    from mca_tpu_torch.models.mca import init_weights
    from mca_tpu_torch.train import clamp_logit_scale

    port, *_ = _separate_case()
    with torch.no_grad():
        for i, p in enumerate(port.parameters()):
            p.fill_(-1.0 if i % 2 else 9.0)
    clamp_logit_scale(port)
    for i, p in enumerate(port.parameters()):
        want = port_losses.LOGIT_SCALE_MIN if i % 2 else port_losses.LOGIT_SCALE_MAX
        assert float(p.detach()) == pytest.approx(want)
    init_weights(port)
    assert all(float(p.detach()) == pytest.approx(port_losses.LOGIT_SCALE_INIT)
               for p in port.parameters())


# -- the batched graph against the per-pair loop ---------------------------

LAYOUTS = {
    "tcga": dict(do_fcl=True, bimodal_contrastive=True, non_fusion_fcl=True),
    "cmu": dict(do_fcl=True),
    "zorro": dict(do_fcl=False),
    "no_fusion": dict(do_fcl=False, no_fusion=True),
    "no_fusion_fcl": dict(do_fcl=True, no_fusion=True, non_fusion_fcl=True),
    "separate": dict(do_fcl=True, bimodal_contrastive=True, non_fusion_fcl=True,
                     separate_modal_loss_fns=True),
}


def _loop_losses(mod, tokens, present):
    """The losses of ``mod``'s configuration as a Python loop of
    :func:`clip_contrastive_loss`, one call a pair, with the aggregates'
    NaN rules: the graph before it was batched."""
    names = list(NAMES)
    emb = {m: tokens[:, i] for i, m in enumerate(names)}
    for i, combo in enumerate(mod.fusion_combos if mod.do_fcl else ()):
        emb[port_losses.combo_key(combo)] = tokens[:, len(names) + i]
    if not mod.no_fusion:
        emb["fusion"] = tokens[:, len(names)]
    mask = {m: torch.from_numpy(present[m]) for m in names}

    def pair_mask(a, b):
        return mask[b] if a == "fusion" else mask[a] if b == "fusion" else mask[a] & mask[b]

    def scale(name):
        return getattr(mod, f"logit_scale_{name}") if mod.separate else mod.loss_fn.logit_scale

    losses = {}
    for a, b in mod._pair_list():
        name = "_".join(sorted((a, b)))
        losses[name] = port_losses.clip_contrastive_loss(emb[a], emb[b], scale(name),
                                                         mask=pair_mask(a, b))
    if mod.do_fcl:
        for combo in mod.fusion_combos[1:]:
            cname = port_losses.combo_log_name(combo, names)
            either = torch.stack([mask[names[i]] for i in combo]).any(dim=0)
            key, t = port_losses.combo_key(combo), scale(f"fcl|{cname}")
            if not mod.no_fusion:
                losses[f"fcl_fusion|{cname}"] = port_losses.clip_contrastive_loss(
                    emb["fusion"], emb[key], t, mask=either)
            if mod.non_fusion_fcl:
                for m in names:
                    losses[f"fcl_{m}|{cname}"] = port_losses.clip_contrastive_loss(
                        emb[m], emb[key], t, mask=mask[m] & either)
    out = {"losses": losses}
    fcl = [v for k, v in losses.items() if "fcl" in k]
    nofcl = [v for k, v in losses.items() if "fcl" not in k]
    if mod.do_fcl and fcl:
        out["fcl_loss"] = torch.stack(fcl).nan_to_num().mean()
    if mod.do_fcl and nofcl:
        out["no-fcl_loss"] = torch.stack(nofcl).nan_to_num().mean()
    stacked = torch.stack(list(losses.values()))
    out["loss"] = stacked.nan_to_num().sum() / torch.isfinite(stacked).sum().float().clamp(min=1.0)
    return out


def _port_module(layout, combos):
    mod = port_losses.MCAPretrainingLoss(NAMES, fusion_combos=combos, **LAYOUTS[layout])
    with torch.no_grad():  # every temperature its own value, inside the clamp
        for i, p in enumerate(mod.parameters()):
            p.fill_(1.0 + 0.1 * i)
    return mod


@pytest.mark.parametrize("empty_pair", [False, True], ids=["all-live", "empty-pair"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_batched_graph_matches_the_pair_loop(layout, empty_pair):
    """The batched graph against a loop of ``clip_contrastive_loss`` over
    the same losses: every per-pair loss, the aggregates, and the
    gradients of the pooled tokens and of every temperature, fp32; the
    keys of ``losses`` in the loop's order; the state dict's keys those
    of the parameters alone (the plan's buffers are not persistent)."""
    pooled, present, combos = _case(3, empty_pair)
    mod = _port_module(layout, combos)
    masks = {k: torch.from_numpy(v) for k, v in present.items()}
    tokens = torch.from_numpy(pooled).requires_grad_(True)
    out = mod(tokens, masks)
    out["loss"].backward()
    got_grads = [tokens.grad.clone()] + [p.grad.clone() for p in mod.parameters()]

    mod.zero_grad()
    ref_tokens = torch.from_numpy(pooled).requires_grad_(True)
    ref = _loop_losses(mod, ref_tokens, present)
    ref["loss"].backward()
    ref_grads = [ref_tokens.grad] + [p.grad for p in mod.parameters()]

    assert list(out["losses"]) == list(ref["losses"]) == list(mod.loss_names)
    assert len(out["losses"]) == mod.pair_slots.numel() // 2
    for k, v in ref["losses"].items():
        got, want = float(out["losses"][k].detach()), float(v.detach())
        if math.isnan(want):
            assert math.isnan(got), k
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL, err_msg=k)
    assert any(math.isnan(float(v.detach())) for v in out["losses"].values()) == empty_pair
    assert {k for k in out if k not in mod.output_keys()} == set(ref)
    for k in set(ref) - {"losses"}:
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k].detach()),
                                   rtol=GRAD_RTOL, err_msg=k)
    for name, got, want in zip(["tokens"] + [n for n, _ in mod.named_parameters()],
                               got_grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(want.abs().max()), err_msg=name)
    want_keys = ([f"logit_scale_{n}" for n in mod.scale_names()]
                 if LAYOUTS[layout].get("separate_modal_loss_fns") else ["loss_fn.logit_scale"])
    assert list(mod.state_dict()) == want_keys


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_loss_graph_ops_do_not_grow_with_pairs():
    """The aten ops that the loss forward and its backward dispatch are as
    many for TCGA's 60 losses as for CMU's 14, and at most 150: the
    per-pair loop (about 90 a pair) does not come back."""
    pooled, present, combos = _case(4, False)
    counts = {}
    for layout in ("tcga", "cmu"):
        mod = _port_module(layout, combos)
        tokens = torch.from_numpy(pooled).requires_grad_(True)
        masks = {k: torch.from_numpy(v) for k, v in present.items()}
        with _CountOps() as fwd:
            out = mod(tokens, masks)
        with _CountOps() as bwd:
            out["loss"].backward()
        counts[len(out["losses"])] = fwd.n + bwd.n
    assert set(counts) == {60, 14}
    assert counts[60] == counts[14] <= 150, counts
