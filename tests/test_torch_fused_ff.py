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
    w1u, w1g, w2p = port_ff.prepare_geglu_weights(w1t, w2t, torch.float32)
    assert w1u.shape == (DIM, 128) and w2p.shape == (128, DIM)
    assert (w1u[:, INNER:] == 0).all() and (w2p[INNER:] == 0).all()
    before = port_ff.launches
    out = port_ff.geglu_ff(xt, w1u, w1g, w2p)
    assert port_ff.launches == before  # no kernel on the CPU
    # zero padding is exact up to fp32 summation order
    torch.testing.assert_close(
        out, port_ff.geglu_ff_reference(xt, w1t, w2t), rtol=1e-6, atol=1e-6
    )
