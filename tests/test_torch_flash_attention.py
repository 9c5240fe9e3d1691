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


def _pair_cases():
    from mca_tpu_torch.tools import roofline as port_roofline

    small = jax_masks.build_masks([48, 30, 40], 14, [3, 2, 1]).attn_mask  # 3 q tiles
    cases = {"small": small}
    for name, variant in (("tcga", ""), ("tcga", "zorro"), ("cmu", "")):
        cases["-".join(x for x in (name, variant) if x)] = port_roofline.build_case(
            name, variant
        )["attn_mask"]
    return cases


@pytest.fixture(scope="module")
def pair_cases():
    return _pair_cases()


@pytest.mark.parametrize("case", ["small", "tcga", "tcga-zorro", "cmu"])
def test_pair_schedule_matches_tile_schedules(pair_cases, case):
    """K1's pair walk lists, for q tiles 2i and 2i + 1, the union of their
    kv tiles with each half's active and full flags exactly as the port's
    ``tile_schedule`` and the JAX ``_tile_schedule`` have them, and a
    tile's mask bits equal the mask (past its edge: blocked)."""
    mask = pair_cases[case]
    t = mask.shape[0]
    pair_ptr, pair_kv, flags, bits = port_flash.pair_schedule(mask)
    row_ptr, col_idx, full = port_flash.tile_schedule(mask)
    qs, ks, fl = _tile_schedule(mask, 64, 64)[:3]
    nq = len(row_ptr) - 1
    assert len(pair_ptr) - 1 == -(-nq // 2) and pair_ptr[-1] == len(pair_kv)
    assert bits.shape == (len(pair_kv), 2, 64) and bits.dtype == np.int64
    jax_tiles = {(int(q), int(k)): int(f) for q, k, f in zip(qs, ks, fl)}
    port_tiles = {
        (i, int(col_idx[n])): int(full[n])
        for i in range(nq) for n in range(row_ptr[i], row_ptr[i + 1])
    }
    assert port_tiles == jax_tiles
    padded = np.ones((-(-nq // 2) * 128, -(-t // 64) * 64), bool)
    padded[:t, :t] = mask
    seen = {}
    for p in range(len(pair_ptr) - 1):
        kvs = pair_kv[pair_ptr[p] : pair_ptr[p + 1]]
        assert (np.diff(kvs) > 0).all()
        for n in range(pair_ptr[p], pair_ptr[p + 1]):
            j = int(pair_kv[n])
            assert flags[n] & 3, "a visited item is active for some half"
            for h in range(2):
                if flags[n] >> h & 1:
                    seen[(2 * p + h, j)] = flags[n] >> (2 + h) & 1
                tile = padded[(2 * p + h) * 64 : (2 * p + h + 1) * 64, j * 64 : (j + 1) * 64]
                row_bits = bits[n, h].view(np.uint64)
                decoded = (row_bits[:, None] >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
                np.testing.assert_array_equal(decoded.astype(bool), tile)
    assert seen == port_tiles
    # sharing: a pair loads each kv tile once for both halves
    assert len(pair_kv) < len(col_idx) or nq == 1
