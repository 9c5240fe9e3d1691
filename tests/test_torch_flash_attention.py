"""The port's flash-attention plain version and dense oracle against
the JAX package (Pallas kernel in interpret mode, as
tests/test_flash_attention.py runs it on the CPU).

Covers an MCA mask, key padding, a missing modality, T not a multiple
of 64 and dead rows (exactly 0 in both), plus the tile schedule and the
dense oracle's finfo.min uniform rows.  Inputs come from numpy with a
seed; fp32 throughout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu import masks as jax_masks
from mca_tpu.ops.attention import dense_masked_attention as jax_dense
from mca_tpu.ops.flash_attention import _tile_schedule, flash_masked_attention
from mca_tpu_torch.ops import flash_attention as port_flash
from mca_tpu_torch.ops.attention import masked_attention

torch.backends.cuda.matmul.allow_tf32 = False

SCALE = 0.125


def _case(seed, b=2, h=2, d=64):
    # 3 modalities + 14 fusion tokens: T = 132, not a multiple of 64
    ms = jax_masks.build_masks([48, 30, 40], 14, [3, 2, 1])
    t = ms.seq_len
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(3))
    pad = np.zeros((b, t), bool)
    pad[0, :48] = True  # modality 0 missing in sample 0
    pad[1, 48 + 20 : 78] = True  # ragged tail of modality 1 in sample 1
    return ms.attn_mask, q, k, v, pad


def _live(mask, pad):
    blocked = mask[None] | pad[:, None, :]
    return ~blocked.all(axis=2)  # [B, T]


@pytest.mark.parametrize("with_pad", [False, True])
def test_reference_matches_jax_flash(with_pad):
    mask, q, k, v, pad = _case(0)
    if not with_pad:
        pad[:] = False
    jout = np.asarray(
        flash_masked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
            attn_mask=mask, key_padding_mask=jnp.asarray(pad),
            block_q=64, block_k=64, interpret=True,
        )
    )
    out, lse = port_flash.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask, torch.from_numpy(pad), SCALE,
    )
    out = out.numpy()
    live = _live(mask, pad)
    for bi in range(q.shape[0]):
        # fp32 both sides; the only difference is the summation order
        # of the online (JAX) vs one-shot (port) softmax: 2e-5 absolute
        # on O(1) outputs
        np.testing.assert_allclose(
            out[bi][:, live[bi]], jout[bi][:, live[bi]], atol=2e-5
        )
        dead = ~live[bi]
        assert (out[bi][:, dead] == 0).all()
        assert (jout[bi][:, dead] == 0).all()
        assert (lse[bi][:, torch.from_numpy(dead)] == port_flash.NEG_INF).all()
    assert (~live).any() == with_pad


def test_wrapper_on_cpu_is_the_plain_version():
    mask, q, k, v, pad = _case(1)
    args = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            mask, torch.from_numpy(pad), SCALE)
    before = port_flash.launches
    a = port_flash.flash_attention(*args)
    b = port_flash.flash_attention_reference(*args)
    assert port_flash.launches == before  # no kernel on the CPU
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    via_auto = masked_attention(*args[:3], scale=SCALE, attn_mask=mask,
                                key_padding_mask=args[4], impl="auto")
    torch.testing.assert_close(via_auto, b[0], rtol=0, atol=0)


@pytest.mark.parametrize("dims,fusion", [([48, 30, 40], 14), ([800, 198, 800, 662], 88)])
def test_tile_schedule_matches_jax(dims, fusion):
    combos = [3, 2, 1] if len(dims) == 3 else [4, 3, 2]
    mask = jax_masks.build_masks(dims, fusion, combos).attn_mask
    row_ptr, col_idx, full = port_flash.tile_schedule(mask)
    qs, ks, fl = _tile_schedule(mask, 64, 64)[:3]
    rows = np.repeat(np.arange(len(row_ptr) - 1), np.diff(row_ptr))
    np.testing.assert_array_equal(rows, qs)
    np.testing.assert_array_equal(col_idx, ks)
    np.testing.assert_array_equal(full, fl)


def test_dense_matches_jax_including_uniform_rows():
    mask, q, k, v, pad = _case(2)
    jout = np.asarray(
        jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=SCALE,
                  attn_mask=jnp.asarray(mask), key_padding_mask=jnp.asarray(pad))
    )
    out = masked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=SCALE, attn_mask=mask, key_padding_mask=torch.from_numpy(pad),
        impl="dense",
    ).numpy()
    # fp32 einsum + softmax on both sides: 1e-5 absolute on O(1) values
    np.testing.assert_allclose(out, jout, atol=1e-5)
    # a fully blocked row is the uniform average over all keys
    dead = ~_live(mask, pad)
    bi, ti = np.argwhere(dead)[0]
    np.testing.assert_allclose(out[bi, :, ti], v[bi].mean(axis=1), atol=1e-5)

