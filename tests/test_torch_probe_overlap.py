"""The port's overlap probe (``mca_tpu_torch/tools/probe_overlap.py``) and
the plain versions of its kernels K7 and K8 (``mca_tpu_torch/ops/
probes.py``) against the JAX package's ``baselines/probe_overlap.py``, on
the CPU: the verdict arithmetic on fabricated times, and each plain
chain, run 1, 4 and 16 times from seeded inputs, against a jnp
transcription of the JAX body it copies (cited by line), within one bf16
unit in bf16 and 1e-6 in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu_torch.ops import probes
from mca_tpu_torch.tools import probe_overlap as port


def jax_record(out, ctl):
    """The verdict arithmetic of baselines/probe_overlap.py:291-332."""
    serial = out["mxu"] + out["vpu"]
    overlap = max(out["mxu"], out["vpu"])
    ctl_serial = ctl["ctl_dma"] + ctl["ctl_mxu"]
    ctl_overlap = max(ctl["ctl_dma"], ctl["ctl_mxu"])
    return {
        "us_per_iter": {k: round(v * 1e6, 4) for k, v in out.items()},
        "serial_bound_us": round(serial * 1e6, 4),
        "overlap_bound_us": round(overlap * 1e6, 4),
        "overlap_fraction": round(
            (serial - out["both"]) / max(serial - overlap, 1e-12), 3
        ),
        "verdict": (
            "OVERLAPS"
            if (serial - out["both"]) > 0.5 * (serial - overlap)
            else "SERIAL"
        ),
        "control_us_per_step": {k: round(v * 1e6, 4) for k, v in ctl.items()},
        "control_serial_bound_us": round(ctl_serial * 1e6, 4),
        "control_overlap_bound_us": round(ctl_overlap * 1e6, 4),
        "control_overlap_fraction": round(
            (ctl_serial - ctl["ctl_both"])
            / max(ctl_serial - ctl_overlap, 1e-12),
            3,
        ),
        "control_verdict": (
            "OVERLAPS"
            if (ctl_serial - ctl["ctl_both"])
            > 0.5 * (ctl_serial - ctl_overlap)
            else "SERIAL"
        ),
    }


US = 1e-6
RECORD_CASES = {
    # both arms balanced, the combined body near their max
    "overlaps": ({"mxu": 5.5 * US, "vpu": 5.3 * US, "both": 6.0 * US},
                 {"ctl_dma": 4.1 * US, "ctl_mxu": 5.9 * US, "ctl_both": 6.1 * US}),
    # the combined body takes the sum
    "serial": ({"mxu": 5.5 * US, "vpu": 5.3 * US, "both": 10.9 * US},
               {"ctl_dma": 4.1 * US, "ctl_mxu": 5.9 * US, "ctl_both": 9.8 * US}),
    # unbalanced control arms (probe_overlap.py:323-326): dma 12.7, mxu
    # 5.0; both at 13.0 is near-perfect overlap though 0.73 of the sum
    "unbalanced": ({"mxu": 2.0 * US, "vpu": 9.0 * US, "both": 9.5 * US},
                   {"ctl_dma": 12.7 * US, "ctl_mxu": 5.0 * US, "ctl_both": 13.0 * US}),
    # slower than the sum: a negative fraction, SERIAL
    "worse_than_serial": ({"mxu": 5.5 * US, "vpu": 10.6 * US, "both": 28.1 * US},
                          {"ctl_dma": 3.0 * US, "ctl_mxu": 5.9 * US, "ctl_both": 6.1 * US}),
}


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_overlap_record_matches_jax(case):
    out, ctl = RECORD_CASES[case]
    mine = port.overlap_record(out, ctl)
    assert mine == jax_record(out, ctl)
    expect = {"overlaps": ("OVERLAPS", "OVERLAPS"), "serial": ("SERIAL", "SERIAL"),
              "unbalanced": ("OVERLAPS", "OVERLAPS"),
              "worse_than_serial": ("SERIAL", "OVERLAPS")}[case]
    assert (mine["verdict"], mine["control_verdict"]) == expect
    if case == "unbalanced":  # a fixed 0.75-of-serial cut would call this SERIAL
        assert ctl["ctl_both"] > 0.72 * (ctl["ctl_dma"] + ctl["ctl_mxu"])


def test_main_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the raise is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.main([])


# ---------------------------------------------------------------------------
# The plain chains against the JAX bodies (baselines/probe_overlap.py)
# ---------------------------------------------------------------------------


def jax_mxu(a, w):
    """baselines/probe_overlap.py:105-111 (and the control's dots,
    :209-214)."""
    a = jax.lax.dot_general(
        a, w, (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )
    return (a * jnp.float32(0.999)).astype(jnp.bfloat16)


def jax_vpu(b):
    """baselines/probe_overlap.py:112."""
    return jnp.exp(-jnp.abs(b)) + jnp.float32(1e-3)


def bf16_unit(ref):
    """The last bf16 place of each entry of ``ref``."""
    ref = np.asarray(ref, np.float64)
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 2.0**-126))) - 7)


@pytest.fixture(scope="module")
def inputs():
    return port.probe_inputs(2, torch.device("cpu"), seed=4, n_chunks=6)


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("mode", probes.PROBE_MODES)
def test_probe_plain_chain_matches_jax(inputs, mode, n):
    """The exp chain contracts, so the whole chain is compared.  The
    matrix chain does not (W is near-orthogonal): fp32 sums taken in
    another order than XLA's flip a bf16 rounding now and then, and the
    chain carries each flip on, so its steps are compared one by one, each
    from the plain chain's own state, and the plain chain of n steps must
    be exactly those steps.  A step is held to one bf16 unit, widened where
    the 256 terms of an entry cancel to below the fp32 rounding of their
    sum (8 units of 2^-23 of the sum of |terms|)."""
    a, w, b = inputs["a"], inputs["w"], inputs["b"]
    mine_a, mine_b = probes.probe_reference(mode, a, w, b, n)
    jw = jnp.asarray(w.float().numpy(), jnp.bfloat16)
    jb = jnp.asarray(b[1].numpy())
    x = a
    for _ in range(n):
        if mode != "vpu":
            nxt = probes.probe_reference("mxu", x, w, b, 1)[0]
            x1 = x[1].float().numpy()
            ref = np.asarray(jax_mxu(jnp.asarray(x1, jnp.bfloat16), jw), np.float32)
            terms = np.abs(x1) @ np.abs(w.float().numpy()) * 0.999
            err = np.abs(nxt[1].float().numpy() - ref)
            assert (err <= bf16_unit(ref) + 2.0**-20 * terms).all()
            x = nxt
        if mode != "mxu":
            for _ in range(probes.EXP_CALLS):
                jb = jax_vpu(jb)
    torch.testing.assert_close(mine_a, x, rtol=0, atol=0)
    np.testing.assert_allclose(mine_b[1].numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    if mode == "mxu":
        torch.testing.assert_close(mine_b, b, rtol=0, atol=0)


FIXED_POINT_STEPS = 32


def test_probe_exp_chain_shows_its_step_count():
    """One iteration of K7's exp chain is EXP_CALLS steps; from |b| in
    [3, 6] (chip_smoke.py's check inputs) its last step is still far from
    the one before at fp32 tolerance (1e-5 of the entry plus 1e-5 of the
    largest), so the check after one iteration sees a step short, while
    from 32 steps on the chain sits at its fixed point within that
    tolerance."""
    rng = np.random.default_rng(3)
    b = torch.from_numpy(
        rng.uniform(3.0, 6.0, (2, *probes.EXP_SHAPE)) * rng.choice([-1.0, 1.0], (2, *probes.EXP_SHAPE))
    ).float()
    steps = [b]
    for _ in range(max(probes.EXP_CALLS, FIXED_POINT_STEPS)):
        steps.append(probes.abs_exp_step(steps[-1]))

    def outside(x, ref):
        r = ref.abs()
        return ((x - ref).abs() > 1e-5 * (r + r.max())).float().mean()

    full = probes.probe_reference("vpu", torch.zeros(2, 128, 256, dtype=torch.bfloat16),
                                  torch.zeros(256, 256, dtype=torch.bfloat16), b, 1)[1]
    torch.testing.assert_close(full, steps[probes.EXP_CALLS], rtol=0, atol=0)
    assert outside(steps[probes.EXP_CALLS - 1], full) == 1.0
    assert outside(steps[FIXED_POINT_STEPS - 1], steps[FIXED_POINT_STEPS]) == 0.0


@pytest.mark.parametrize("mode", probes.CTL_MODES)
def test_ctl_plain_version(inputs, mode):
    """The control's plain version: the streamed chunks are x (1 + c), as
    the JAX control's y = x (1 + c) (probe_overlap.py:200) for every
    fresh block; ctl_mxu scales its resident chunk once per step (the
    port keeps the chunk in shared memory and scales it in place); the
    dots are steps x dots steps of the matrix chain (:209-214)."""
    x, a, w = inputs["x"], inputs["a"], inputs["w"]
    steps, dots, scale = 5, 2, 1.25
    y0 = torch.full_like(x, -7.0)
    y, a_out = probes.ctl_reference(mode, x, y0, a, w, steps, dots, scale)
    expect = y0.clone()
    if mode == "ctl_mxu":
        for blk in range(2):  # the chunk of step 0
            z = x[blk * 3].numpy()
            for _ in range(steps):
                z = z * np.float32(scale)
            expect[blk * 3] = torch.from_numpy(z)
    else:
        for i in range(steps):
            for blk in range(2):
                c = blk * 3 + i % 3  # each block walks its own 3 chunks
                expect[c] = x[c] * np.float32(scale)
    torch.testing.assert_close(y, expect, rtol=0, atol=0)
    # the dots are the matrix chain held to JAX above
    chain = probes.probe_reference("mxu", a, w, inputs["b"], 0 if mode == "ctl_dma" else steps * dots)
    torch.testing.assert_close(a_out, chain[0], rtol=0, atol=0)


def test_probe_wrappers_route_cpu_to_plain_and_refuse_others(inputs):
    before = dict(probes.launches)
    a, w, b, x, y = (inputs[k] for k in ("a", "w", "b", "x", "y"))
    got = probes.probe_overlap("both", a, w, b, 1)
    for g, r in zip(got, probes.probe_reference("both", a, w, b, 1)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    got = probes.probe_overlap_ctl("ctl_both", x, y, a, w, 2, 1, 1.5)
    for g, r in zip(got, probes.ctl_reference("ctl_both", x, y, a, w, 2, 1, 1.5)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in inputs.items()}
    with pytest.raises(RuntimeError, match="not meta"):
        probes.probe_overlap("mxu", meta["a"], meta["w"], meta["b"], 1)
    with pytest.raises(RuntimeError, match="not meta"):
        probes.probe_overlap_ctl("ctl_dma", meta["x"], meta["y"], meta["a"], meta["w"], 1, 1, 1.0)
    with pytest.raises(ValueError, match="mode"):
        probes.probe_overlap("mufu", a, w, b, 1)
    assert probes.launches == before


SASS = """
        Function : _Z3fooPf
        /*0000*/  HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0010*/  HMMA.16816.F32.BF16 R16, R8, R14, R16 ;
        /*0020*/  MUFU.EX2 R2, R3 ;
        /*0030*/  @P0 BRA 0x10 ;
        Function : _Z3barPf
        /*0000*/  MUFU.RCP R2, R3 ;
        /*0010*/  EXIT ;
"""


def test_sass_counts_reads_each_function():
    from mca_tpu_torch.tools import sass_counts

    got = sass_counts.count(SASS)
    none = {"HGMMA": 0, "WGWAIT": 0, "UTMALDG": 0, "UTMAREDG": 0}
    assert got["_Z3fooPf"] == {"HMMA": 2, "MUFU.EX2": 1, "BRA": 1, "lines": 4, **none}
    assert got["_Z3barPf"] == {"HMMA": 0, "MUFU.EX2": 0, "BRA": 0, "lines": 2, **none}


HOPPER_SASS = """
        Function : _Z6hopperv
        /*0000*/  UTMALDG.3D [UR8], [UR4] ;
        /*0010*/  UTMALDG.2D [UR16], [UR12] ;
        /*0020*/  SYNCS.ARRIVE.TRANS64.RED.A1T0 RZ, [UR6], RZ ;
        /*0030*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0040*/  HGMMA.64x256x16.F32.BF16 R88, gdesc[UR8], R88, gsb0 ;
        /*0050*/  WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*0060*/  MUFU.EX2 R2, R3 ;
"""


def test_sass_counts_reads_wgmma_and_tma():
    """K1 and K5 are checked for HGMMA (wgmma) and UTMALDG (TMA tensor
    loads) and for the absence of HMMA (mma.sync)."""
    from mca_tpu_torch.tools import sass_counts

    got = sass_counts.count(HOPPER_SASS)["_Z6hopperv"]
    assert got == {
        "HMMA": 0, "HGMMA": 2, "WGWAIT": 1, "UTMALDG": 2, "UTMAREDG": 0, "MUFU.EX2": 1,
        "BRA": 0, "lines": 7,
    }


# as cuobjdump prints K2's dq reduce (cp.reduce.async.bulk.tensor ... .add)
REDUCE_SASS = """
        Function : _ZN12_GLOBAL__N_119flash_bwd_kv_kernelILb1EEEv14CUtensorMap_st
        /*4c20*/  UTMAREDG.3D.ADD [UR12], [UR18] ;
        /*4cc0*/  UTMAREDG.3D.ADD [UR12], [UR18] ;
        /*4ce0*/  UTMACMDFLUSH ;
        /*5820*/  UTMALDG.3D [UR8], [UR4] ;
        /*5830*/  HGMMA.64x64x16.F32.BF16 R24, gdesc[UR20].tnspA.tnspB, RZ, !UPT, gsb0 ;
        /*5840*/  WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
"""


def test_sass_counts_reads_the_tma_reduce():
    """K2 is checked for UTMAREDG, the TMA reduce-add that adds its dq
    partials (K3b, without dq, has none)."""
    from mca_tpu_torch.tools import sass_counts

    (got,) = sass_counts.count(REDUCE_SASS).values()
    assert got == {
        "HMMA": 0, "HGMMA": 1, "WGWAIT": 1, "UTMALDG": 1, "UTMAREDG": 2, "MUFU.EX2": 0,
        "BRA": 0, "lines": 6,
    }


def probe_sass(both="HGMMA", vpu="", mxu="HGMMA", both_exp=True):
    """A made-up ``cuobjdump -sass`` of K7's library: its three kernels
    (as the mangled names of probe_overlap_kernel<kDoMxu, kDoExp> read),
    each holding the products named (HGMMA for wgmma, HMMA for mma.sync)
    and MUFU.EX2 where its mode has the exp chain."""
    product = {
        "HGMMA": "HGMMA.64x256x16.F32.BF16 R24, gdesc[UR12], R24 ;",
        "HMMA": "HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
        "": "NOP ;",
    }
    prefix = "_ZN49_GLOBAL__N__b8b163d2_16_probe_overlap_cu_d509350f20probe_overlap_kernel"
    suffix = "EEEvPK13__nv_bfloat16S3_PKfPS1_Pfi"
    out = []
    for tag, prod, exp in (("ILb1ELb1E", both, both_exp), ("ILb0ELb1E", vpu, True),
                           ("ILb1ELb0E", mxu, False)):
        out.append(f"        Function : {prefix}{tag}{suffix}")
        out.append(f"        /*0000*/  {product[prod]}")
        out.append("        /*0010*/  MUFU.EX2 R0, R0 ;" if exp else "        /*0010*/  FADD R0, R0, R1 ;")
        out.append("        /*0020*/  EXIT ;")
    return "\n".join(out) + "\n"


SASS_RULE_CASES = {
    "wgmma": (probe_sass(), []),
    "both_on_mma_sync": (probe_sass(both="HMMA"), ["both: 1 HMMA (mma.sync)", "both: 0 HGMMA"]),
    "both_without_exp": (probe_sass(both_exp=False), ["both: 0 MUFU.EX2"]),
    "mxu_on_mma_sync": (probe_sass(mxu="HMMA"), ["mxu: 1 HMMA (mma.sync)", "mxu: 0 HGMMA"]),
    "vpu_with_products": (probe_sass(vpu="HGMMA"), ["vpu: 1 HGMMA"]),
}


@pytest.mark.parametrize("case", sorted(SASS_RULE_CASES))
def test_probe_sass_rule(case):
    """chip_smoke.py phase 1's rule for K7, on made-up SASS: a wgmma
    ``both`` with MUFU.EX2 (and a wgmma ``mxu``, a product-free ``vpu``)
    passes; ``both`` or ``mxu`` on HMMA, ``both`` without MUFU.EX2 and
    ``vpu`` with HGMMA are each refused, with what is wrong."""
    import chip_smoke
    from mca_tpu_torch.tools import sass_counts

    sass, expect = SASS_RULE_CASES[case]
    counts = sass_counts.count(sass)
    assert len(counts) == 3
    assert chip_smoke.probe_sass_faults(counts) == expect


def test_probe_sass_rule_needs_every_mode():
    """A library missing a mode, or holding a kernel that is not K7's,
    is refused."""
    import chip_smoke
    from mca_tpu_torch.tools import sass_counts

    counts = sass_counts.count(probe_sass())
    mxu = next(fn for fn in counts if "ILb1ELb0E" in fn)
    missing = {fn: c for fn, c in counts.items() if fn != mxu}
    assert chip_smoke.probe_sass_faults(missing) == ["K7 kernels found: ['both', 'vpu']"]
    stranger = dict(counts, _Z3fooPf=counts[mxu])
    assert chip_smoke.probe_sass_faults(stranger) == ["_Z3fooPf: not one of K7's kernels"]
