"""The counts against brute force at small shapes, and the refusal of
shares outside (0, 105]."""

import numpy as np
import pytest
import torch

from portbench import counts
from portbench.reference.model import Layout, ff_inner
from portbench.tests.conftest import tiny_config
from portbench.trace import Trace

CONFIGS = ["tiny_tab", "tiny_seq"]


def count_matmul(a_shape, b_shape, mask=None):
    """Multiply-adds of ``a @ b``, counted entry by entry, times 2; with
    ``mask`` only the output entries it keeps."""
    m, k = a_shape
    _, n = b_shape
    keep = np.ones((m, n), bool) if mask is None else mask
    total = 0
    for i in range(m):
        for j in range(n):
            if keep[i, j]:
                total += sum(1 for _ in range(k))
    return 2 * total


@pytest.mark.parametrize("name", CONFIGS)
def test_live_entries_by_brute_force(name):
    cfg = tiny_config(name)
    lay = Layout(cfg)
    live = sum(1 for i in range(lay.seq_len) for j in range(lay.seq_len)
               if not lay.attn_blocked[i, j])
    assert counts.live_entries(cfg) == live


@pytest.mark.parametrize("name", CONFIGS)
def test_attention_operations_by_brute_force(name):
    cfg = tiny_config(name)
    lay = Layout(cfg)
    t, dh, h = lay.seq_len, int(cfg["dim_head"]), int(cfg["heads"])
    keep = ~lay.attn_blocked
    per_head = count_matmul((t, dh), (dh, t), keep) + count_matmul((t, dh), (dh, t), keep)
    flops, nbytes = counts.attn_fwd_work(cfg, 3)
    assert flops == 3 * h * per_head
    assert nbytes == 3 * h * 4 * t * dh * 2
    assert counts.attn_bwd_work(cfg, 3)[0] == 5 * flops // 2


def test_gemm_and_feed_forward_by_brute_force():
    assert counts.gemm_flops(3, 5, 7) == count_matmul((3, 5), (5, 7))
    cfg = tiny_config("tiny_tab")
    d, inner, t = int(cfg["hidden_size"]), ff_inner(cfg), counts.sample_tokens(cfg)
    want = count_matmul((t, d), (d, 2 * inner)) + count_matmul((t, inner), (inner, d))
    assert counts.geglu_ff_work(cfg, 1)[0] == want


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_operations_match_a_counting_mode(name):
    """The forward's matrix products, counted by torch's own FLOP
    counter over the reference (all its products are einsums), less the
    dense attention's blocked entries, which the count leaves out."""
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.data import make_rows, make_weights
    from portbench.reference.model import Reference
    from portbench.reference.train import collate

    cfg = tiny_config(name)
    rows = make_rows(cfg, 2, seed=1, p_missing=0.0)
    ref = Reference(cfg)
    params = make_weights(cfg, 2, "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.pooled(params, collate(cfg, rows, "cpu"))
    lay = Layout(cfg)
    t, r = lay.seq_len, len(lay.return_types)
    h, dh = int(cfg["heads"]), int(cfg["dim_head"])
    dense_blocks = int(cfg["layers"]) * 2 * 2 * dh * h * 2 * t * t
    dense_pool = 2 * 2 * dh * h * 2 * r * t
    live = (int(cfg["layers"]) * counts.attn_fwd_work(cfg, 2)[0]
            + 2 * 2 * 2 * dh * h * counts.pool_live_entries(cfg))
    # a product over a contraction of width 1 (the value encoder's first
    # layer) is a broadcast multiply to the counting mode
    one_wide = sum(2 * counts.gemm_flops(int(e["max_tokens"]), 1, int(cfg["hidden_size"]))
                   for e in cfg["encoder_configs"].values() if e["type"] == "TabularEncoder")
    seen = fc.get_total_flops() - dense_blocks - dense_pool + live + one_wide
    assert seen == counts.forward_flops(cfg, 2)


def test_share_refuses_outside():
    assert counts.share(1.0, 2.0, "x") == 50.0
    assert counts.share(1.05, 1.0, "x") == pytest.approx(105.0)
    for part, whole in ((0.0, 1.0), (1.06, 1.0), (1.0, 0.0), (-1.0, 1.0)):
        with pytest.raises(ValueError):
            counts.share(part, whole, "x")


def fake_ctx(seconds_per_launch, launches=5, name="flash_fwd_kernel"):
    dev = [(name, i * 10**9, i * 10**9 + int(seconds_per_launch * 1e9)) for i in range(launches)]
    trace = Trace(dev, [("pb.window", 0, launches * 10**9)], [])
    cfg = tiny_config("tiny_tab")
    return {"cfg": cfg, "device_type": "cuda", "launch_batch": 4096, "trace": trace,
            "host": {"steps": 2, "elapsed_s": 1.0, "rows": 3, "flops_per_row": 1.0,
                     "flops_per_step": 1.0}}


@pytest.mark.parametrize("metric,work,kernel", [
    ("attn_fwd_roofline.train", counts.attn_fwd_work, "flash_fwd_kernel"),
    ("attn_bwd_roofline.train", counts.attn_bwd_work, "flash_bwd_kv_kernel<true>"),
    ("attn_fwd_roofline.serve", counts.attn_fwd_work, "flash_fwd_kernel"),
    ("geglu_ff_roofline.serve", counts.geglu_ff_work, "geglu_ff_kernel"),
])
def test_roofline_readers(metric, work, kernel):
    from portbench.harness import reader

    read = reader(metric)
    cfg = tiny_config("tiny_tab")
    bound = counts.bound_seconds(*work(cfg, 4096))
    assert read(fake_ctx(bound * 4, name=kernel)) == pytest.approx(25.0, rel=1e-3)
    with pytest.raises(ValueError):
        read(fake_ctx(bound / 2, name=kernel))  # 200%
    assert read(fake_ctx(bound, name="other_kernel")) is None
    assert read(dict(fake_ctx(bound, name=kernel), device_type="cpu")) is None


@pytest.mark.parametrize("metric,flops_key", [("mfu.train", "flops_per_step"),
                                              ("mfu.serve", "flops_per_row")])
def test_mfu_readers(metric, flops_key):
    from portbench.harness import reader

    read = reader(metric)
    ctx = fake_ctx(1e-3)
    scale = 2 if metric == "mfu.train" else 3  # steps, rows
    ctx["host"][flops_key] = 0.5 * counts.PEAK_BF16_FLOPS / scale
    assert read(ctx) == pytest.approx(50.0)
    ctx["host"][flops_key] = 1.2 * counts.PEAK_BF16_FLOPS / scale
    with pytest.raises(ValueError):
        read(ctx)
    ctx["host"][flops_key] = 0.0
    with pytest.raises(ValueError):
        read(ctx)


def test_idle_share_and_breakdown():
    dev = [("k1", 0, 40), ("k2", 30, 60), ("k1", 80, 90)]
    tr = Trace(dev, [("pb.window", 0, 100), ("pb.loader", 60, 80)], [("aten::copy_", 62, 75)])
    assert tr.busy_s == pytest.approx(70e-9)
    assert tr.idle_gaps() == [(60, 80), (90, 100)]
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["k1", pytest.approx(50e-9)]
    assert bd["idle_gaps"][0] == ["pb.loader / aten::copy_", pytest.approx(20e-9)]
    from portbench.readers import idle_share
    from portbench.trace import Busy

    assert idle_share({"device_type": "cuda", "busy": Busy(0.7, 1.0)}) == pytest.approx(30.0)
    assert idle_share({"device_type": "cuda", "trace": tr}) is None  # host and device: not read
    assert idle_share({"device_type": "cpu", "busy": Busy(0.7, 1.0)}) is None
