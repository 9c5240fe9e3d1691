"""The port's roofline tool (``mca_tpu_torch/tools/roofline.py``) and the
plain bodies of its counter kernel K6 (``mca_tpu_torch/ops/probes.py``)
against the JAX package's ``baselines/roofline.py``, on the CPU.

The counting functions must agree with the JAX ones exactly where the
kernels do the same work, and each device-memory term where they do not
is held to the formula the port's docstring states.  The plain bodies,
run 1, 4 and 16 times from seeded inputs, must match a jnp transcription
of the JAX body each copies (cited by line): within 1e-6 in fp32 and one
bf16 unit in bf16.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.ops.flash_attention import _tile_schedule
from mca_tpu_torch.ops import probes
from mca_tpu_torch.tools import roofline as port

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(__file__)), "baselines")
)

import roofline as jax_roofline  # noqa: E402

CASES = [("tcga", ""), ("tcga", "zorro"), ("cmu", "")]
B, H, D = 8, 8, 64


@pytest.fixture(scope="module")
def built():
    return {}


def _cases(built, case):
    if case not in built:
        built[case] = (port.build_case(*case), jax_roofline.build_case(*case))
    return built[case]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(x for x in c if x))
def test_build_case_matches_jax(built, case):
    mine, ref = _cases(built, case)
    np.testing.assert_array_equal(mine["attn_mask"], ref["attn_mask"])
    assert mine["seq_len"] == ref["seq_len"]
    assert mine["cfg_like"] == ref["cfg_like"]
    # counted from the port's model, not the JAX tool's fixed 16.6M
    assert 10_000_000 < mine["n_params"] < 25_000_000


def _jax_terms(mask, bl=64, d=D, io=2):
    """The JAX count's byte terms for one band (0, T, 0, T, 64, 64), from
    its own tile schedule (baselines/roofline.py:106-143)."""
    t = mask.shape[0]
    q_of, kv_of, full, *_ = _tile_schedule(mask, bl, bl)
    n_tiles, n_masked = len(q_of), int((full == 0).sum())
    n_q_runs = int((np.diff(q_of) != 0).sum()) + 1
    n_kv_runs = int((np.diff(np.sort(kv_of)) != 0).sum()) + 1
    fwd = {
        "k_v_tiles": n_tiles * 2 * bl * d * io,
        "q": n_q_runs * bl * d * io,
        "out_lse": n_q_runs * bl * (d * io + 4),
        "mask_tiles": n_masked * bl * bl,
        "key_padding": n_tiles * bl,
    }
    bwd = {
        "k_v_tiles": n_tiles * 2 * bl * d * io,
        "q_do_tiles": n_tiles * 2 * bl * d * io,
        "lse_delta_tiles": n_tiles * bl * 8,
        "dq_flush": t * d * 4,
        "dk_dv": n_kv_runs * 2 * bl * d * io,
        "mask_tiles": n_masked * bl * bl,
        "key_padding": n_tiles * bl,
    }
    return fwd, bwd, n_tiles


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(x for x in c if x))
def test_attention_counts_match_jax(built, case):
    mask = _cases(built, case)[0]["attn_mask"]
    t = mask.shape[0]
    mine = port.attention_counts(mask, batch=B, heads=H, dim_head=D)
    ref = jax_roofline.attention_counts(
        mask, [(0, t, 0, t, 64, 64)], batch=B, heads=H, dim_head=D
    )
    for dirn in ("fwd", "bwd"):
        for key in ("mxu_flops", "vpu_elems", "exp_elems", "mxu_by_shape"):
            assert mine[dirn][key] == ref[dirn][key], (dirn, key)
    jf, jb, n_tiles = _jax_terms(mask)
    bh = B * H
    # the JAX count is the sum of the terms transcribed above
    assert ref["fwd"]["hbm_bytes"] == bh * sum(jf.values())
    assert ref["bwd"]["hbm_bytes"] == bh * sum(jb.values())
    # the port's terms: shared ones equal the JAX ones, the others follow
    # the formulas of port.attention_counts' docstring
    # K1 loads k and v once per (pair of q tiles, kv tile) item and reads
    # a tile that is not full as 64 words of 64 bits
    n_items = len(port.pair_schedule(mask)[1])
    assert n_tiles / 2 <= n_items < n_tiles
    fwd = {
        "k_v_tiles": n_items * 2 * 64 * D * 2,
        "q": t * D * 2,
        "out_lse": t * (D * 2 + 4),
        "mask_bits": jf["mask_tiles"] // (64 * 64) * 64 * 8,
        "key_padding": jf["key_padding"],
    }
    bwd = {
        "k_v": t * 2 * D * 2,
        "q_do_tiles": jb["q_do_tiles"],
        "lse_delta_tiles": jb["lse_delta_tiles"],
        "dq_atomics": n_tiles * 64 * D * 4,
        "dk_dv": t * 2 * D * 2,
        "mask_tiles": jb["mask_tiles"],
        "key_padding": t,
    }
    assert mine["fwd"]["hbm_terms"] == {k: float(bh * v) for k, v in fwd.items()}
    assert mine["bwd"]["hbm_terms"] == {k: float(bh * v) for k, v in bwd.items()}
    for dirn in ("fwd", "bwd"):
        assert mine[dirn]["hbm_bytes"] == sum(mine[dirn]["hbm_terms"].values())


def test_attention_counts_tiny_mask_by_hand():
    """130 x 130, nothing blocked: 3 x 3 tiles, the 5 on the ragged edge
    not full; 1 batch x 2 heads, d 4.  K1's pairs are q tiles (0, 1) and
    (2, none), 3 kv tiles each: 6 k / v loads for the 9 tiles."""
    mask = np.zeros((130, 130), bool)
    c = port.attention_counts(mask, batch=1, heads=2, dim_head=4)
    bh, n, m, t, d = 2, 9, 5, 130, 4
    assert c["fwd"]["mxu_flops"] == bh * n * 2 * 2 * 64 * 64 * d
    assert c["bwd"]["mxu_flops"] == bh * n * 5 * 2 * 64 * 64 * d
    assert c["fwd"]["mxu_by_shape"] == {"fwdpair:64x4x64": c["fwd"]["mxu_flops"]}
    assert c["bwd"]["exp_elems"] == bh * n * 64 * 64
    assert c["fwd"]["hbm_terms"]["k_v_tiles"] == bh * 6 * 2 * 64 * d * 2
    assert c["fwd"]["hbm_terms"]["mask_bits"] == bh * m * 64 * 8
    assert c["fwd"]["hbm_terms"]["key_padding"] == bh * n * 64
    assert c["bwd"]["hbm_terms"]["mask_tiles"] == bh * m * 64 * 64
    assert c["bwd"]["hbm_terms"]["dq_atomics"] == bh * n * 64 * d * 4
    assert c["bwd"]["hbm_terms"]["key_padding"] == bh * t


def test_gemm_flops_and_optimizer_bytes_match_jax(built):
    case = _cases(built, ("tcga", ""))[0]
    assert port.gemm_flops(case["cfg_like"], case["seq_len"]) == jax_roofline.gemm_flops(
        case["cfg_like"], case["seq_len"]
    )
    for n, mb in ((100, 4), (100, 2), (case["n_params"], 4)):
        assert port.optimizer_bytes(n, mb) == jax_roofline.optimizer_bytes(n, mb)


@pytest.mark.parametrize("with_shapes", [True, False])
def test_light_ms_matches_jax(built, with_shapes):
    mask = _cases(built, ("tcga", ""))[0]["attn_mask"]
    counts = port.attention_counts(mask, batch=B, heads=H, dim_head=D)
    rates = {"mxu_flops_s": 3e14, "vpu_elems_s": 2e13, "exp_elems_s": 3e12,
             "hbm_bytes_s": 2.9e12}
    if with_shapes:
        rates["mxu_shape_rates"] = {"fwdpair:64x64x64": 4e14, "bwd5:64x64x64": 3.5e14}
    for dirn in ("fwd", "bwd"):
        assert port.light_ms(counts[dirn], rates) == jax_roofline.light_ms(counts[dirn], rates)


def test_rate_ceilings_and_check():
    ceil = port.rate_ceilings(1980.0, 132)
    assert ceil["exp_elems_s"] == 16 * 132 * 1980e6
    rates = {"mxu_shape_rates": {"fwdpair:64x64x64": 5e14, "bwd5:64x64x64": 4e14},
             "mxu_big_flops_s": 6e14, "vpu_elems_s": 4e13, "exp_elems_s": 3.9e12,
             "hbm_bytes_s": 3.0e12}
    frac = port.check_rates(rates, ceil)
    assert frac["mxu_shape_rates[fwdpair:64x64x64]"] == 5e14 / 989e12
    for key, bad in (("hbm_bytes_s", 3.6e12), ("vpu_elems_s", 0.0)):
        with pytest.raises(RuntimeError, match=key):
            port.check_rates({**rates, key: bad}, ceil)


def test_main_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main([])


# ---------------------------------------------------------------------------
# K6's plain bodies against the JAX bodies (baselines/roofline.py)
# ---------------------------------------------------------------------------


def _dot(a, b, dims):
    return jax.lax.dot_general(a, b, (dims, ((), ())), preferred_element_type=jnp.float32)


def jax_fwdpair(q, kmat, vmat, eps):
    """baselines/roofline.py:366-375."""
    s = _dot(q, kmat, ((1,), (1,)))
    o = _dot(s.astype(q.dtype), vmat, ((1,), (0,)))
    return (q + o * eps).astype(q.dtype)


# baselines/roofline.py:390-410, unmodified: each product of the backward
# tile as its dot_general, by its operands (do = q)
JAX_BWD5 = {
    "s": lambda q, k, v, ds: _dot(q, k, ((1,), (1,))),
    "dp": lambda q, k, v, ds: _dot(q, v, ((1,), (1,))),
    "dv": lambda q, k, v, ds: _dot(ds, q, ((0,), (0,))),
    "dk": lambda q, k, v, ds: _dot(ds, q, ((0,), (0,))),
    "dq": lambda q, k, v, ds: _dot(ds, k, ((1,), (0,))),
}


def jax_bwd5(q, kmat, vmat, eps):
    """baselines/roofline.py:388-412, with dv's dot_general given
    bf16(s) where the TPU body gives it ds: the port's one stated
    difference (csrc/roofline_counter.cu), held product by product in
    test_bwd5_products_match_jax."""
    s = JAX_BWD5["s"](q, kmat, vmat, None)
    ds = (s + JAX_BWD5["dp"](q, kmat, vmat, None)).astype(q.dtype)
    dv = JAX_BWD5["dv"](q, kmat, vmat, s.astype(q.dtype))
    dk = JAX_BWD5["dk"](q, kmat, vmat, ds)
    dq = JAX_BWD5["dq"](q, kmat, vmat, ds)
    fold = jnp.sum(dv + dk, axis=0, keepdims=True)
    return (q + (dq + fold) * eps).astype(q.dtype)


def jax_big(a, bmat, eps, n):
    """baselines/roofline.py:430-435."""
    s = _dot(a, bmat, ((1,), (0,)))
    return (a + s * eps * (1.0 / n)).astype(a.dtype)


def jax_vpu(x, coef):
    """baselines/roofline.py:449-450."""
    return x - coef * x * x


def jax_exp(x, eps):
    """baselines/roofline.py:461-462."""
    return jnp.exp(-x - eps)


def bf16_units(x, ref):
    """|x - ref| in units of ref's last bf16 place."""
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-126))) - 7)
    return np.abs(x - ref) / unit


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return t.float().numpy()


def _bwd5_step_bound(x, k, v, eps):
    """How far one bwd5 step of the port may land from the jnp one on
    the same state ``x`` (numpy fp32, one block): one bf16 unit, widened
    where the terms of an entry cancel to below the fp32 rounding of
    their sum (8 units of 2^-23 of the sum of |terms|), and by the reach
    of any entry of bf16(s) or ds that the two round to different bf16
    values from fp32 sums taken in another order."""
    xb = jnp.asarray(x, jnp.bfloat16)
    mine = probes.bwd5_products(_bf16(x), _bf16(k), _bf16(v))
    s_j = JAX_BWD5["s"](xb, jnp.asarray(k, jnp.bfloat16), None, None)
    dp_j = JAX_BWD5["dp"](xb, None, jnp.asarray(v, jnp.bfloat16), None)
    ds_j = np.asarray((s_j + dp_j).astype(jnp.bfloat16), np.float32)
    sb_j = np.asarray(s_j.astype(jnp.bfloat16), np.float32)
    sb, ds = _np(mine["s"].to(torch.bfloat16)), _np(mine["ds"])
    ax, ak = np.abs(x), np.abs(k)
    terms = np.abs(ds) @ ak + (np.abs(sb).T @ ax + np.abs(ds).T @ ax).sum(0)
    flips = np.abs(ds - ds_j) @ ak + (
        np.abs(sb - sb_j).T @ ax + np.abs(ds - ds_j).T @ ax
    ).sum(0)
    return 2.0**-20 * (ax + eps * terms) + eps * flips


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("mode", probes.COUNTER_MODES)
def test_counter_plain_body_matches_jax(mode, n):
    rng = np.random.default_rng(11)
    if mode == "fwdpair":
        q = _bf16(rng.standard_normal((64, 64)))
        kv = _bf16(rng.standard_normal((128, 64)) * 0.125)
        eps = 0.05
        mine = probes.counter_reference(mode, q[None], kv, n, eps)[0]
        x = jnp.asarray(_np(q), jnp.bfloat16)
        k, v = (jnp.asarray(_np(kv[i * 64:(i + 1) * 64]), jnp.bfloat16) for i in (0, 1))
        for _ in range(n):
            x = jax_fwdpair(x, k, v, jnp.float32(eps))
        assert bf16_units(_np(mine), np.asarray(x, np.float32)).max() <= 1.0
    elif mode == "bwd5":
        # chip_smoke.py's check inputs, where dq, dv and dk each move q
        # (test_bwd5_chain_needs_every_product), at an eps that keeps 16
        # iterations bounded.  Each step from the plain chain's own state,
        # as bf16 roundings taken apart by the sum order carry on
        q, kv, _ = probes.counter_check_inputs("bwd5", 2, seed=11)
        eps = float(np.float32(0.06 / n))
        k, v = _np(kv[:64]), _np(kv[64:])
        kj, vj = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16)
        x = q
        for _ in range(n):
            nxt = probes.counter_reference(mode, x, kv, 1, eps)
            for blk in range(2):
                xb = _np(x[blk])
                ref = np.asarray(jax_bwd5(jnp.asarray(xb, jnp.bfloat16), kj, vj,
                                          jnp.float32(eps)), np.float32)
                err = np.abs(_np(nxt[blk]) - ref)
                unit = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-126))) - 7)
                assert (err <= unit + _bwd5_step_bound(xb, k, v, eps)).all()
            x = nxt
        torch.testing.assert_close(probes.counter_reference(mode, q, kv, n, eps), x,
                                   rtol=0, atol=0)
    elif mode == "big":
        a = _bf16(rng.standard_normal((128, 256)))
        w = _bf16(rng.standard_normal((256, 256)) / 16)
        eps = 2.56
        mine = probes.counter_reference(mode, a[None], w, n, float(np.float32(eps / 256)))[0]
        x = jnp.asarray(_np(a), jnp.bfloat16)
        wj = jnp.asarray(_np(w), jnp.bfloat16)
        for _ in range(n):
            x = jax_big(x, wj, jnp.float32(eps), 256)
        assert bf16_units(_np(mine), np.asarray(x, np.float32)).max() <= 1.0
    else:
        x0 = rng.uniform(0.05, 0.95, (64, 64)).astype(np.float32)
        const = 0.5 if mode == "vpu" else 0.01
        mine = probes.counter_reference(mode, torch.from_numpy(x0)[None], None, n, const)[0]
        x = jnp.asarray(x0)
        for _ in range(n):
            x = (jax_vpu if mode == "vpu" else jax_exp)(x, jnp.float32(const))
        np.testing.assert_allclose(mine.numpy(), np.asarray(x), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("product", ["s", "dp", "ds", "dv", "dk", "dq"])
def test_bwd5_products_match_jax(product):
    """Each product of the plain bwd5 body against the unmodified JAX
    dot_general (baselines/roofline.py:390-410) on the same operands: fp32
    products to the fp32 rounding of their sum (2^-20 of the sum of
    |terms|), ds exactly.  dv is the stated difference: JAX's dv
    dot_general with bf16(s) in place of ds, which moves it."""
    q, kv, _ = probes.counter_check_inputs("bwd5", 1, seed=5)
    q, k, v = q[0], kv[:64], kv[64:]
    mine = probes.bwd5_products(q, k, v)
    qj, kj, vj = (jnp.asarray(_np(t), jnp.bfloat16) for t in (q, k, v))
    ds = jnp.asarray(_np(mine["ds"]), jnp.bfloat16)
    if product == "ds":
        ref = (jnp.asarray(_np(mine["s"])) + jnp.asarray(_np(mine["dp"]))).astype(jnp.bfloat16)
        np.testing.assert_array_equal(_np(mine["ds"]), np.asarray(ref, np.float32))
        return
    operand = ds
    if product == "dv":
        sb = jnp.asarray(_np(mine["s"].to(torch.bfloat16)), jnp.bfloat16)
        tpu = np.asarray(JAX_BWD5["dv"](qj, kj, vj, ds))
        assert np.abs(_np(mine["dv"]) - tpu).max() > 0.1 * np.abs(tpu).max()
        operand = sb
    ref = np.asarray(JAX_BWD5[product](qj, kj, vj, operand))
    absf = lambda t: np.abs(np.asarray(t, np.float32))  # noqa: E731
    terms = np.asarray(JAX_BWD5[product](
        *(jnp.asarray(absf(t), jnp.bfloat16) for t in (qj, kj, vj, operand))))
    assert (np.abs(_np(mine[product]) - ref) <= 2.0**-20 * terms).all()


@pytest.mark.parametrize("fault", ["dq", "dv", "dk", "one iteration short"])
def test_bwd5_chain_needs_every_product(fault):
    """At chip_smoke.py's check inputs and 4 iterations, the plain bwd5
    chain with one product left out (or one iteration short) puts most
    entries outside chip_smoke.py's bf16 tolerance of the whole chain, so
    a kernel that dropped or garbled one would fail there."""
    q, kv, eps = probes.counter_check_inputs("bwd5", 4, seed=3)
    ref = probes.counter_reference("bwd5", q, kv, 4, eps)
    if fault == "one iteration short":
        got = probes.counter_reference("bwd5", q, kv, 3, eps)
    else:
        got = q
        for _ in range(4):
            p = probes.bwd5_products(got, kv[:64], kv[64:])
            p[fault] = torch.zeros_like(p[fault])
            fold = (p["dv"] + p["dk"]).sum(dim=-2, keepdim=True)
            got = (got.float() + (p["dq"] + fold) * eps).to(torch.bfloat16)
    r = ref.float().abs()
    tol = 2.0**-6 * (r + r.max())
    assert ((got.float() - ref.float()).abs() > tol).float().mean() > 0.2


def test_counter_chains_move():
    """The bodies really iterate: n and n - 1 iterations differ (the
    planted fault chip_smoke.py checks on the card)."""
    rng = np.random.default_rng(2)
    q = _bf16(rng.standard_normal((2, 64, 64)))
    kv = _bf16(rng.standard_normal((128, 64)) * 0.125)
    a = probes.counter_reference("fwdpair", q, kv, 4, 0.2)
    b = probes.counter_reference("fwdpair", q, kv, 3, 0.2)
    assert (a != b).float().mean() > 0.5
    x = torch.from_numpy(rng.uniform(0.1, 0.9, (2, 64, 64)).astype(np.float32))
    assert not torch.allclose(
        probes.counter_reference("vpu", x, None, 4, 0.5),
        probes.counter_reference("vpu", x, None, 3, 0.5), rtol=1e-2,
    )


@pytest.mark.parametrize("mode", probes.COUNTER_MODES)
def test_counter_check_inputs_expose_one_iteration_short(mode):
    """At chip_smoke.py's check inputs, the plain chain one iteration
    short of CHECK_ITERS (4) puts entries outside its tolerance: 2^-6 (bf16)
    or 1e-5 (fp32) of the entry plus the same of the largest."""
    x0, aux, const = probes.counter_check_inputs(mode, 3, seed=7)
    ref = probes.counter_reference(mode, x0, aux, 4, const)
    short = probes.counter_reference(mode, x0, aux, 3, const)
    rtol = 2.0**-6 if ref.dtype == torch.bfloat16 else 1e-5
    r = ref.float().abs()
    assert ((short.float() - ref.float()).abs() > rtol * (r + r.max())).float().mean() > 0.2


def test_counter_wrapper_routes_cpu_to_plain_and_refuses_others():
    before = dict(probes.launches)
    x = torch.full((3, 64, 64), 0.5)
    out = probes.roofline_counter("vpu", x, None, 2, 0.5)
    torch.testing.assert_close(out, probes.counter_reference("vpu", x, None, 2, 0.5))
    meta = torch.empty((3, 64, 64), device="meta")
    with pytest.raises(RuntimeError, match="not meta"):
        probes.roofline_counter("vpu", meta, None, 2, 0.5)
    with pytest.raises(ValueError, match="mode"):
        probes.roofline_counter("square", x, None, 2, 0.5)
    assert probes.launches == before
