"""The port's GEGLU feed-forward plain version against the JAX package's
fused Pallas kernel (interpret mode), at an inner width that is not a
multiple of 64 (dim 40 -> inner 106) and a row count that is not a
multiple of the block."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu.ops.fused_ff import fused_geglu_ff
from mca_tpu_torch.ops import fused_ff as port_ff

torch.backends.cuda.matmul.allow_tf32 = False

DIM = 40
INNER = int(DIM * 4 * 2 / 3)  # 106


def _inputs(dtype=np.float32):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 37, DIM)).astype(np.float32)  # 111 rows
    w1 = (rng.normal(size=(DIM, 2 * INNER)) / np.sqrt(DIM)).astype(np.float32)
    w2 = (rng.normal(size=(INNER, DIM)) / np.sqrt(INNER)).astype(np.float32)
    return x, w1, w2


@pytest.mark.parametrize(
    "dtype,tol",
    [
        # fp32 both sides, same arithmetic in another summation order
        (torch.float32, 2e-5),
        # bf16 inputs: both accumulate in fp32 and round the gated
        # product and the output to bf16; one bf16 ulp of O(1) outputs
        (torch.bfloat16, 1.6e-2),
    ],
)
def test_reference_matches_jax_fused(dtype, tol):
    x, w1, w2 = _inputs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout = fused_geglu_ff(
        jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(w2, jdt),
        32, True,  # block_m 32: 111 rows are not a multiple of it
    )
    xt, w1t, w2t = (torch.from_numpy(a).to(dtype) for a in (x, w1, w2))
    out = port_ff.geglu_ff_reference(xt, w1t, w2t)
    assert out.dtype == dtype
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(jout, np.float32), atol=tol, rtol=tol
    )


def test_prepared_weights_and_cpu_wrapper():
    x, w1, w2 = _inputs()
    xt, w1t, w2t = (torch.from_numpy(a) for a in (x, w1, w2))
    pw1, pw2 = port_ff.prepare_geglu_weights(w1t, w2t, torch.float32)
    # transposed, inner padded 106 -> 128, u and gate rows interleaved
    assert pw1.shape == (2 * 128, DIM) and pw2.shape == (DIM, 128)
    assert pw1.is_contiguous() and pw2.is_contiguous()
    assert (pw2[:, INNER:] == 0).all()
    before = port_ff.launches
    out = port_ff.geglu_ff(xt, pw1, pw2)
    assert port_ff.launches == before  # no kernel on the CPU
    # zero padding is exact up to fp32 summation order
    torch.testing.assert_close(
        out, port_ff.geglu_ff_reference(xt, w1t, w2t), rtol=1e-6, atol=1e-6
    )


def test_prepared_layout_round_trips_and_interleaves():
    """``split_geglu_weights`` gives back ``[u | g]`` and W2 exactly, zero
    past the inner width; each 64-row chunk of the prepared W1 is
    ``u 32 | g 32 | u 32 | g 32`` of the same inner columns."""
    _, w1, w2 = _inputs()
    w1t, w2t = torch.from_numpy(w1), torch.from_numpy(w2)
    pw1, pw2 = port_ff.prepare_geglu_weights(w1t, w2t, torch.float32)
    w1u, w1g, w2p = port_ff.split_geglu_weights(pw1, pw2)
    assert w1u.shape == w1g.shape == (DIM, 128) and w2p.shape == (128, DIM)
    assert torch.equal(torch.cat([w1u[:, :INNER], w1g[:, :INNER]], dim=1), w1t)
    assert torch.equal(w2p[:INNER], w2t)
    for t in (w1u[:, INNER:], w1g[:, INNER:], w2p[INNER:]):
        assert (t == 0).all()
    half = port_ff.HALF_CHUNK
    for c in range(128 // 64):
        rows = pw1[128 * c : 128 * (c + 1)]
        for r, (src, col) in enumerate([(w1u, 0), (w1g, 0), (w1u, half), (w1g, half)]):
            cols = slice(64 * c + col, 64 * c + col + half)
            assert torch.equal(rows[half * r : half * (r + 1)], src[:, cols].t())


@pytest.mark.parametrize(
    "dtype,tol",
    [
        # the same tolerances as test_reference_matches_jax_fused: the
        # plain version on the prepared layout does the reference's
        # arithmetic, with zero terms added for the padding
        (torch.float32, 2e-5),
        (torch.bfloat16, 1.6e-2),
    ],
)
def test_plain_on_prepared_layout_matches_jax_fused(dtype, tol):
    x, w1, w2 = _inputs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jout = fused_geglu_ff(
        jnp.asarray(x, jdt), jnp.asarray(w1, jdt), jnp.asarray(w2, jdt), 32, True
    )
    xt, w1t, w2t = (torch.from_numpy(a).to(dtype) for a in (x, w1, w2))
    prepared = port_ff.prepare_geglu_weights(w1t, w2t, dtype)
    out = port_ff.geglu_ff_plain(xt, *prepared)
    assert out.dtype == dtype and out.shape == xt.shape
    np.testing.assert_allclose(
        out.float().numpy(), np.asarray(jout, np.float32), atol=tol, rtol=tol
    )
