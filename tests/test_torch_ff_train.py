"""The training GEGLU feed-forward (``FeedForward(fused=False)``) at its
inner width padded to a multiple of 64, and the zero-padded weight
layouts it shares with K5's ``prepare_geglu_weights``.

On the CPU, at TCGA_config1's widths (dim 512, inner 1365 run as 1408)
and at an inner width that is a multiple of 64 already (dim 96, inner
256): the padded chain's output and its gradients of x, W1 and W2 equal
the unpadded chain's at fp32, and at TCGA's widths the JAX package's;
the gradients have the parameters' shapes and the state dict is
unchanged; every product the forward and backward issue has every
dimension but the token count a multiple of 64, and nothing
concatenates the halves; the padded layouts hold the weights and exact
zeros, and K5's interleaved layout is built from them as before.

On the card only (``-m card``; JAX is imported inside the tests that
compare against it, so this file runs there with ``--noconftest``): one
profiled training step of TCGA_config1 at batch 8 runs no pre-Hopper
CUTLASS GEMM, and its loss is the unpadded chain's within the bf16
step's rounding.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from mca_tpu_torch.models import layers
from mca_tpu_torch.models.layers import FeedForward
from mca_tpu_torch.ops import fused_ff

ROOT = Path(__file__).resolve().parents[1]
DIM, INNER, COLS = 512, 1365, 1408
ROWS = 300


def _unpadded(ff: FeedForward, x: torch.Tensor) -> torch.Tensor:
    """The chain as it ran before the padding: one product into
    ``[N, 2 * inner]``, halves by ``chunk``."""
    x = x.to(ff.dtype)
    w1, w2 = ff.feedforward[0].weight, ff.feedforward[2].weight
    h, gate = F.linear(x, w1.to(ff.dtype)).chunk(2, dim=-1)
    return F.linear(F.gelu(gate, approximate="none") * h, w2.to(ff.dtype))


def _ff_and_inputs(dim=DIM, rows=ROWS, seed=0):
    torch.manual_seed(seed)
    ff = FeedForward(dim, fused=False)
    x = torch.randn(3, rows // 3, dim)
    dy = torch.randn(3, rows // 3, dim)
    return ff, x, dy


def _run(ff, fn, x, dy):
    """Output and the gradients of x, W1 and W2 of ``fn`` at ``x``."""
    ff.zero_grad(set_to_none=True)
    x = x.clone().requires_grad_()
    out = fn(x)
    out.backward(dy)
    return out.detach(), x.grad, ff.feedforward[0].weight.grad, ff.feedforward[2].weight.grad


def _close(got, want, rtol=1e-5):
    """Entry by entry within ``rtol`` of the reference's largest entry's
    magnitude (fp32 values near zero carry its rounding, not their own)."""
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("dim", [DIM, 96])  # inner 1365 -> 1408; 256, a multiple already
def test_padded_chain_equals_the_unpadded_chain_at_fp32(dim):
    ff, x, dy = _ff_and_inputs(dim=dim)
    got = _run(ff, ff, x, dy)
    want = _run(ff, lambda t: _unpadded(ff, t), x, dy)
    for name, g, w in zip(("out", "dx", "dW1", "dW2"), got, want):
        assert g.shape == w.shape, name
        _close(g.numpy(), w.numpy())


def test_padded_chain_matches_jax_at_fp32(monkeypatch):
    monkeypatch.setenv("MCA_FUSED_FF", "0")
    import jax
    import jax.numpy as jnp

    from mca_tpu.models.layers import FeedForward as JaxFeedForward

    ff, x, dy = _ff_and_inputs()
    got = _run(ff, ff, x, dy)
    params = {"params": {
        "w_in": {"kernel": jnp.asarray(ff.feedforward[0].weight.detach().numpy().T)},
        "w_out": {"kernel": jnp.asarray(ff.feedforward[2].weight.detach().numpy().T)},
    }}
    jff = JaxFeedForward(DIM)
    out, vjp = jax.vjp(lambda p, xx: jff.apply(p, xx), params, jnp.asarray(x.numpy()))
    dp, dx = vjp(jnp.asarray(dy.numpy()))
    want = (out, dx, np.asarray(dp["params"]["w_in"]["kernel"]).T,
            np.asarray(dp["params"]["w_out"]["kernel"]).T)
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))


def test_gradients_and_state_dict_keep_the_parameters_shapes():
    ff, x, dy = _ff_and_inputs(rows=30)
    before = {k: tuple(v.shape) for k, v in ff.state_dict().items()}
    assert before == {"feedforward.0.weight": (2 * INNER, DIM),
                      "feedforward.2.weight": (DIM, INNER)}
    _run(ff, ff, x, dy)
    assert {k: tuple(v.shape) for k, v in ff.state_dict().items()} == before
    for name, p in ff.named_parameters():
        assert p.grad.shape == p.shape and p.grad.dtype == p.dtype, name
        assert p.grad.is_contiguous(), name
    assert not list(ff.buffers())


def test_bf16_chain_casts_at_use_and_returns_fp32_gradients():
    torch.manual_seed(0)
    ff = FeedForward(DIM, dtype=torch.bfloat16, fused=False)
    x = torch.randn(2, 40, DIM).requires_grad_()
    out = ff(x)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad.dtype == torch.float32
    for p in ff.parameters():
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()


class _Ops(TorchDispatchMode):
    """The aten operations issued, with their argument shapes."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        shapes = [tuple(a.shape) for a in args if isinstance(a, torch.Tensor)]
        if func.overloadpacket in (torch.ops.aten.cat, torch.ops.aten.stack):
            shapes += [tuple(t.shape) for t in args[0]]
        self.ops.append((func.overloadpacket.__name__, shapes))
        return func(*args, **(kwargs or {}))


def test_every_product_is_aligned_and_no_halves_are_concatenated():
    ff, x, dy = _ff_and_inputs(rows=99)  # 33 tokens a row: no multiple of 64
    n = 99
    with _Ops() as rec:
        _run(ff, ff, x, dy)
    products = [(op, s) for op, s in rec.ops if op in ("mm", "addmm", "addmm_", "bmm", "matmul",
                                                       "linear", "baddbmm")]
    assert {op for op, _ in products} == {"mm"}
    assert len(products) == 3 + 6  # u, g, out; dact, dW2, and each half's dx and dW1
    for op, shapes in products:
        dims = [d for s in shapes for d in s if d != n]
        assert dims and all(d % 64 == 0 for d in dims), (op, shapes)
    assert not [s for op, s in rec.ops if op in ("cat", "stack")]


def _former_layout(w1, w2, dtype):
    """``prepare_geglu_weights`` as it built K5's layout before it shared
    the padded halves: each half written into a zero buffer, then
    interleaved in runs of 32."""
    d, two_inner = w1.shape
    inner = two_inner // 2
    ip = (inner + 63) // 64 * 64
    halves = w1.new_zeros((2, ip, d), dtype=dtype)
    halves[0, :inner] = w1[:, :inner].t()
    halves[1, :inner] = w1[:, inner:].t()
    w1t = halves.reshape(2, ip // 32, 32, d).transpose(0, 1).reshape(2 * ip, d)
    w2t = w2.new_zeros((w2.shape[1], ip), dtype=dtype)
    w2t[:, :inner] = w2.t()
    return w1t, w2t


@pytest.mark.parametrize("dim, cols", [(DIM, COLS), (96, 256)])
def test_padded_layouts_hold_the_weights_and_zeros(dim, cols):
    ff, _, _ = _ff_and_inputs(dim=dim, rows=3)
    w1, w2 = ff.feedforward[0].weight.detach(), ff.feedforward[2].weight.detach()
    inner = w2.shape[1]
    halves = fused_ff.padded_halves(w1, torch.bfloat16)
    cols2 = fused_ff.padded_columns(w2, torch.bfloat16)
    assert halves.shape == (2, cols, dim) and cols2.shape == (dim, cols)
    assert halves.dtype == cols2.dtype == torch.bfloat16 and cols2.is_contiguous()
    assert torch.equal(halves[0, :inner], w1[:inner].bfloat16())
    assert torch.equal(halves[1, :inner], w1[inner:].bfloat16())
    assert torch.equal(cols2[:, :inner], w2.bfloat16())
    assert not halves[:, inner:].any() and not cols2[:, inner:].any()
    for dtype in (torch.float32, torch.bfloat16):
        got = fused_ff.prepare_geglu_weights(w1.t(), w2.t(), dtype)
        for g, w in zip(got, _former_layout(w1.t(), w2.t(), dtype)):
            assert g.is_contiguous() and torch.equal(g, w)


# -- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: cuBLAS's kernel choice needs one")
    return torch.device("cuda")


def _step(config, card, batch, params=None):
    """One training step on ``batch`` from ``params`` (the trainer's own
    initial weights if None): the loss, the names of the device kernels
    it ran, and the weights it started from."""
    from mca_tpu_torch.train import build_trainer, train_step

    model, opt, sched = build_trainer(config, "cuda", num_training_steps=1000, params=params)
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        m = train_step(model, opt, sched, batch, clip=float(config.clip or 0.0))
        torch.cuda.synchronize(card)
    names = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}
    return m["total_loss"], names, start


@pytest.mark.card
def test_the_training_step_runs_no_pre_hopper_gemm(card, monkeypatch):
    import json

    from mca_tpu_torch.config import training_config
    from mca_tpu_torch.data.collators import MultimodalCollator
    from mca_tpu_torch.train import synthetic_rows, to_device

    config = training_config(str(ROOT / "configs/tcga_mca.yaml"))
    config.batch_size = 8
    rows = synthetic_rows(config, 8, seed=3)
    batch = to_device(MultimodalCollator(config.modality_config.to_plain())(rows), card)
    loss, names, start = _step(config, card, batch)
    old = sorted(n for n in names if "cutlass_75_tensorop" in n or "cutlass_80_tensorop" in n)
    assert not old, old
    assert any("nvjet" in n or "sm90" in n for n in names)

    monkeypatch.setattr(layers.FeedForward, "forward", _unpadded)
    want, _, _ = _step(config, card, batch, start)
    limit = json.loads((ROOT / "portbench/limits/tcga_mca.train.b64.json").read_text())["loss_gap"]
    assert abs(loss - want) <= limit * abs(want), (loss, want)
