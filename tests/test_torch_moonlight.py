"""The ``deepseek_v3`` block (Moonlight-16B-A3B's decoder block as the
MCA fusion stack) on the CPU, at a tiny size with the published
structure: hidden 64, 2 heads, ``kv_lora`` 16, nope 16, rope 8, v 16,
one dense SwiGLU layer then two MoE layers of 8 routed experts, top 2,
4 held (``ep_size`` 2), 2 shared.

Held against ``portbench/reference/moonlight.py`` (plain fp32 PyTorch,
which imports nothing of the port): the forward, the loss and every
leaf's gradient in fp32 and in bf16, three training steps with the bias
update, and the expert shares; the flash attention's plain versions at
head dims (192, 128) against a dense oracle; ``EmbeddingService.embed``
and ``infer`` of the tiny configuration; the refusals; and, on the card
only, K1 / K2 at (192, 128) against their plain versions.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mca_tpu_torch import checkpoint, infer
from mca_tpu_torch.config import block_config, get_model_config, training_config_from_dict
from mca_tpu_torch.data.collators import MultimodalCollator
from mca_tpu_torch.models import build_model
from mca_tpu_torch.models.routed_moe import RoutedMoE, routed_layers
from mca_tpu_torch.ops import flash_attention as flash
from mca_tpu_torch.ops.attention import dense_masked_attention
from mca_tpu_torch.serve import EmbeddingService
from mca_tpu_torch.train import build_trainer, to_device, train_step, training_loss
from mca_tpu_torch.utils import trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.data import make_rows  # noqa: E402
from portbench.reference import moonlight as ref_ml  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture
def card():
    """A CUDA device, or the test skips: the kernels run only on the card."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: K1 / K2 have no CPU mode")
    return torch.device("cuda")


def tiny(**over) -> dict:
    cfg = json.loads((ROOT / "portbench/tests/data/tiny_moonlight.json").read_text())
    cfg.pop("meta")
    cfg.update(over)
    return cfg


def weights(cfg: dict, seed: int = 5) -> dict:
    """Seeded random leaves of the reference's specs, the norms' scales
    and the correction biases moved off their initial values too."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape, init in ref_ml.param_specs(cfg):
        if init == "normal":
            out[name] = torch.randn(shape, generator=g)
        elif init == "uniform":
            out[name] = (torch.rand(shape, generator=g) * 2 - 1) * shape[-1] ** -0.5
        elif init == "ones":
            out[name] = 1 + 0.1 * torch.randn(shape, generator=g)
        elif init == "zeros":
            out[name] = 0.01 * torch.randn(shape, generator=g)
        else:
            out[name] = torch.full(shape, float(np.log(1 / 0.07)))
    return out


def rows_of(cfg: dict, n: int = 8, seed: int = 123):
    return make_rows(cfg, n, seed, 0.25)


def port_batch(cfg: dict, rows):
    return to_device(MultimodalCollator(cfg["modality_config"])(rows), "cpu")


def port_grads(cfg: dict, w: dict, rows):
    model, _, _ = build_trainer(training_config_from_dict(cfg), "cpu", 100, params=w)
    out = model(port_batch(cfg, rows))
    loss = training_loss(out)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def ref_grads(cfg: dict, w: dict, rows, block: int = 3):
    ref = ref_ml.MoonlightReference(cfg)
    total, grads, _, _ = ref_ml.gradients(ref, {k: v.clone() for k, v in w.items()}, rows,
                                          block, "cpu")
    return float(total), grads


def worst_leaf_gap(got: dict, want: dict) -> float:
    """The worst leaf's gradient gap, over the larger of that leaf's norm
    and the median leaf's (as the benchmark's ``grad_gap``)."""
    med = float(np.median([float(g.norm()) for g in want.values()]))
    return max(float((got[k] - g).norm()) / max(float(g.norm()), med) for k, g in want.items())


# fp32 on both sides; the gaps are summation order (the flash plain
# version's tile walk against a dense softmax, grouped products against
# a loop over the experts, the blocked reference gradient): ~1e-7
# relative on the loss, a few 1e-6 on the worst leaf (measured)
FP32_LOSS_RTOL = 1e-5
FP32_GRAD_GAP = 1e-4


def test_forward_loss_and_gradients_match_the_reference_fp32():
    cfg = tiny(precision="fp32")
    w, rows = weights(cfg), rows_of(cfg)
    loss, got = port_grads(cfg, w, rows)
    want_loss, want = ref_grads(cfg, w, rows)
    assert set(got) == set(want)
    assert abs(loss - want_loss) <= FP32_LOSS_RTOL * abs(want_loss)
    assert worst_leaf_gap(got, want) < FP32_GRAD_GAP


# bf16 blocks against the fp32 reference: every projection, both
# attention products and the experts' products round their inputs to
# bf16 (8 bits of mantissa, 4e-3 relative), about a dozen such roundings
# in a row through three blocks; the loss stays within 1e-2 and the
# worst leaf's gradient within 0.1 of the larger of its norm and the
# median leaf's (measured 2.7e-3 and 5.4e-2)
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_GAP = 0.1


def test_bf16_forward_loss_and_gradients_near_the_reference():
    cfg = tiny(precision="bf16")
    w, rows = weights(cfg), rows_of(cfg)
    loss, got = port_grads(cfg, w, rows)
    want_loss, want = ref_grads(cfg, w, rows)
    assert abs(loss - want_loss) <= BF16_LOSS_RTOL * abs(want_loss)
    assert worst_leaf_gap(got, want) < BF16_GRAD_GAP


def test_three_training_steps_with_the_bias_update():
    """Three steps of ``train_step`` from the same leaves and rows as the
    reference's: the losses, each leaf's change and the correction biases
    (moved by the update rule after each step, from the same integer
    loads) agree."""
    cfg = tiny(precision="fp32")
    w = weights(cfg)
    pool = rows_of(cfg, 24, seed=7)
    batches = [pool[i * 8:(i + 1) * 8] for i in range(3)]
    model, opt, sched = build_trainer(training_config_from_dict(cfg), "cpu", 1000, params=w)
    losses = [train_step(model, opt, sched, port_batch(cfg, b), clip=float(cfg["clip"]))
              ["total_loss"] for b in batches]
    ref = ref_ml.train_steps(cfg, w, batches, 1000, 4, "cpu")
    np.testing.assert_allclose(losses, ref["losses"], rtol=FP32_LOSS_RTOL)
    state = model.state_dict()
    for name, want in ref["bias"].items():
        assert torch.equal(state[name], want), name
        assert not torch.equal(want, w[name]), "the update moved the bias"
    med = float(np.median(list(ref["change"].values())))
    for name, p in model.named_parameters():
        got = float((p.detach() - w[name]).norm())
        # fp32 summation order carried through three AdamW steps, over
        # the larger of the leaf's change and the median leaf's (as the
        # benchmark's update_gap): measured 8e-6
        assert abs(got - ref["change"][name]) <= 1e-4 * max(ref["change"][name], med), name


@pytest.mark.parametrize("cut", [4, 2])
def test_expert_shares_add_up_to_the_uncut_layer(cut):
    """Two shares of one routed layer, [0, cut) and [cut, 8), the shared
    experts counted once, give the uncut reference layer's output."""
    cfg = tiny(precision="fp32")
    d, e, k, inner = 64, 8, 2, 24
    w = weights(dict(cfg, ep_size=1))
    p = "layers.1."
    torch.manual_seed(0)
    x = torch.randn(2, 10, d)
    pad = torch.zeros(2, 10, dtype=torch.bool)
    pad[1, 6:] = True
    got = torch.zeros_like(x)
    for lo, hi in ((0, cut), (cut, 8)):
        m = RoutedMoE(d, e, k, inner, 2, (lo, hi), 2.446).eval()
        m.load_state_dict({"gate.weight": w[p + "ff.gate.weight"],
                           "gate.e_score_correction_bias": w[p + "ff.gate.e_score_correction_bias"],
                           "w1": w[p + "ff.w1"][lo:hi], "w2": w[p + "ff.w2"][lo:hi],
                           "shared.w1.weight": w[p + "ff.shared.w1.weight"],
                           "shared.w2.weight": w[p + "ff.shared.w2.weight"]}, strict=True)
        with torch.no_grad():
            got += m(x, pad)
    reference = ref_ml.MoonlightReference(dict(cfg, ep_size=1))
    with torch.no_grad():
        want, _, _, _ = reference.moe(w, p, x, ~pad)
        shared = reference.swiglu(x.reshape(-1, d), w[p + "ff.shared.w1.weight"],
                                  w[p + "ff.shared.w2.weight"]).view_as(x)
    # fp32; the shares' sums and the reference's loop add in another order
    torch.testing.assert_close(got - shared, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("pass_", ["forward", "backward"])
def test_flash_plain_versions_at_192_128_match_a_dense_oracle(pass_):
    """The kernels' plain versions at latent attention's head dims (q, k
    192; v 128), under a fusion-channel style mask with key padding and
    a fully padded row, against the dense masked softmax, in fp32."""
    rng = np.random.default_rng(0)
    b, h, t = 2, 2, 80
    mask = rng.random((t, t)) < 0.6
    np.fill_diagonal(mask, False)
    q = torch.from_numpy(rng.normal(size=(b, h, t, 192)).astype(np.float32)).requires_grad_()
    k = torch.from_numpy(rng.normal(size=(b, h, t, 192)).astype(np.float32)).requires_grad_()
    v = torch.from_numpy(rng.normal(size=(b, h, t, 128)).astype(np.float32)).requires_grad_()
    pad = torch.zeros(b, t, dtype=torch.bool)
    pad[0, 60:] = True
    scale = 192 ** -0.5
    out, _ = flash.flash_attention(q, k, v, mask, pad, scale)
    assert out.shape == (b, h, t, 128)
    dense = dense_masked_attention(q, k, v, scale=scale, attn_mask=torch.from_numpy(mask),
                                   key_padding_mask=pad)
    if pass_ == "forward":
        torch.testing.assert_close(out, dense, rtol=1e-5, atol=1e-5)
        return
    g = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad((out * g).sum(), (q, k, v))
    want = torch.autograd.grad((dense * g).sum(), (q, k, v))
    for a, b_ in zip(got, want):
        # fp32, ~80 terms a gradient entry summed in another order
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=2e-5)


def test_split_backward_is_refused_at_192_128():
    q = torch.zeros(1, 1, 64, 192, requires_grad=True)
    v = torch.zeros(1, 1, 64, 128, requires_grad=True)
    out, lse = flash.flash_attention(q, q, v, None, None, 0.1, "split")
    with pytest.raises(ValueError, match="split"):
        out.sum().backward()


def test_embed_and_infer_of_the_tiny_configuration(tmp_path):
    cfg_d = tiny(precision="fp32", batch_size=4)
    w = weights(cfg_d)
    cfg = training_config_from_dict(cfg_d)
    rows = rows_of(cfg_d, 6, seed=3)
    svc = EmbeddingService(cfg, params=w, max_batch=4, device="cpu")
    out = svc.embed(rows)
    model = build_model(get_model_config(cfg), fused_ff=True)
    model.load_state_dict(w, strict=True)
    model.eval()
    with torch.inference_mode():
        direct = model(port_batch(cfg_d, rows), no_loss=True)
    for key in svc.emb_keys:
        np.testing.assert_allclose(out["embeddings"][key], direct[key].numpy(), rtol=1e-5,
                                   atol=1e-6)
    # infer: the six files from a saved model
    checkpoint.save_params(w, str(tmp_path / "model"))
    labelled = [dict(r, Labels={"values": np.eye(2, dtype=np.float32)[i % 2]})
                for i, r in enumerate(rows_of(cfg_d, 16, seed=4))]
    cfg.restart, cfg.output_dir, cfg.split = str(tmp_path / "model"), str(tmp_path / "out"), 0.25
    infer.infer(cfg, device="cpu", rows=labelled)
    emb = infer.load_embedding_file(str(tmp_path / "out" / "train_embeddings"))
    assert emb and all(np.isfinite(v).all() for v in emb.values())


def test_routing_counters():
    cfg = tiny(precision="fp32")
    model, opt, sched = build_trainer(training_config_from_dict(cfg), "cpu", 100,
                                      params=weights(cfg))
    mark = trace.RECORDER.mark()
    train_step(model, opt, sched, port_batch(cfg, rows_of(cfg)))
    held = trace.RECORDER.records("moe.held_tokens", since=mark)["value"]
    most = trace.RECORDER.records("moe.held_max", since=mark)["value"]
    assert len(held) == len(most) == len(routed_layers(model)) == 2
    # 4 held experts: the most on one is at least their mean
    assert (held > 0).all() and (most * 4 >= held).all() and (most <= held).all()
    names = {n for n in trace.RECORDER.records(prefix="moe.", since=mark)["name"]}
    assert {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"} <= names


def test_every_held_assignment_is_computed():
    """A router that sends every token to the held experts: the dispatch
    buffer holds them all (no capacity drops a token), forward and
    backward, against a loop over the experts."""
    torch.manual_seed(1)
    d, inner = 16, 8
    m = RoutedMoE(d, 8, 2, inner, 0, (0, 4), 1.0)
    with torch.no_grad():
        for p in m.parameters():
            p.uniform_(-0.5, 0.5)
        m.gate.e_score_correction_bias[:4] = 10.0  # experts 0-3 always win
    x = torch.randn(2, 5, d, requires_grad=True)
    out = m(x)
    (out * torch.arange(d)).sum().backward()
    got_x, got_w1 = x.grad.clone(), m.w1.grad.clone()
    x.grad, m.w1.grad = None, None
    h = x.reshape(-1, d)
    idx, w, _ = m.route(h)
    assert (idx < 4).all()
    want = torch.zeros(10, d)
    for e in range(4):
        hit = (idx == e)
        y = torch.nn.functional.linear(h, m.w1[e])
        gate, up = y.chunk(2, dim=-1)
        y = torch.nn.functional.linear(torch.nn.functional.silu(gate) * up, m.w2[e])
        want = want + (w * hit).sum(-1, keepdim=True) * y
    torch.testing.assert_close(out.reshape(-1, d), want, rtol=1e-5, atol=1e-6)
    (want * torch.arange(d)).sum().backward()
    torch.testing.assert_close(got_x, x.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got_w1, m.w1.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key,value", [
    ("q_lora_rank", 64), ("scoring_func", "softmax"), ("topk_method", "greedy"),
    ("n_group", 2), ("zorro", True), ("eao", True), ("no_fusion", True), ("mesh_model", 2),
    ("seq_shard", True), ("mesh_pipe", 2), ("remat", True), ("quantize", "int8"),
    ("attention_impl", "segmented"), ("bwd_impl", "split"), ("aux_loss_alpha", None),
])
def test_the_block_refuses_what_it_does_not_run(key, value):
    with pytest.raises(ValueError, match=key):
        block_config(training_config_from_dict(tiny(**{key: value})))


def test_int8_serving_is_refused():
    with pytest.raises(ValueError, match="int8"):
        EmbeddingService(training_config_from_dict(tiny(precision="fp32")), quantize="int8",
                         device="cpu", warmup=False)


@pytest.mark.card
@pytest.mark.parametrize("pass_", ["K1", "K2"])
def test_kernels_at_192_128_match_their_plain_versions(card, pass_):
    """K1 / K2 at (192, 128) on the card against the plain versions at
    the same bf16 inputs, on TCGA_config1's mask with key padding."""
    from mca_tpu_torch import masks

    mask = masks.build_masks([800, 198, 800, 662], 88, [4, 3, 2], fcl=True).attn_mask
    t = mask.shape[0]
    g = torch.Generator(device=card).manual_seed(0)
    q, k = (torch.randn(2, 16, t, 192, device=card, generator=g).bfloat16() for _ in range(2))
    v = torch.randn(2, 16, t, 128, device=card, generator=g).bfloat16()
    pad = torch.zeros(2, t, dtype=torch.bool, device=card)
    pad[0, :800] = True
    scale = 192 ** -0.5
    out, lse = flash.flash_attention(q, k, v, mask, pad, scale)
    if pass_ == "K1":
        ro, _ = flash.flash_attention_reference(q, k, v, mask, pad, scale)
        # p rounded to bf16 in both; the online softmax's rescaling
        # against one softmax: a bf16 ulp of the output
        assert (out.float() - ro.float()).abs().max().item() < 1e-2
        return
    do = torch.randn(out.shape, device=card, generator=g).bfloat16()
    got = flash.flash_attention_backward(q, k, v, mask, pad, out, lse, do, scale, "fused")
    want = flash.flash_attention_bwd_reference(q, k, v, mask, pad, out, lse, do, scale)
    for a, b in zip(got, want):
        # bf16 outputs of fp32 sums in another order: 1e-3 relative
        assert ((a.float() - b.float()).norm() / b.float().norm()).item() < 1e-3
    assert got[1][0, :, :800].abs().max().item() == 0.0  # padded keys
