"""The port's flash-attention backward on the CPU (its plain version,
reached through autograd) against ``jax.grad`` of the JAX package's
flash attention (Pallas kernels in interpret mode, block 64), for both
the fused and the split backward.

Covers an MCA mask, key padding, a missing modality, T not a multiple
of 64 (132), dead query rows (dq exactly 0) and padded keys (dk, dv
exactly 0), plus the kv-major tile schedule.  Inputs come from numpy
with a seed; fp32 throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mca_tpu import masks as jax_masks
from mca_tpu.ops.flash_attention import _tile_schedule, flash_masked_attention
from mca_tpu_torch.ops import flash_attention as port_flash

torch.backends.cuda.matmul.allow_tf32 = False

SCALE = 0.125
# fp32 on both sides; the gradients sum up to ~130 terms per entry in
# another order (and the JAX side in base-e online-softmax statistics
# per 64-wide tile): 2e-4 absolute, the JAX package's own bar for its
# flash gradients against the dense oracle
GRAD_ATOL = 2e-4


def _case(seed, b=2, h=2, d=64):
    # 3 modalities + 14 fusion tokens: T = 132, not a multiple of 64
    ms = jax_masks.build_masks([48, 30, 40], 14, [3, 2, 1], fcl=True)
    t = ms.seq_len
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.normal(size=(b, h, t, d)).astype(np.float32) for _ in range(4))
    pad = np.zeros((b, t), bool)
    pad[0, :48] = True  # modality 0 missing in sample 0
    pad[1, 48 + 20 : 78] = True  # ragged tail of modality 1 in sample 1
    return ms.attn_mask, q, k, v, g, pad


def _jax_grads(mask, q, k, v, g, pad, bwd_impl):
    def f(q, k, v):
        out = flash_masked_attention(
            q, k, v, scale=SCALE, attn_mask=mask,
            key_padding_mask=jnp.asarray(pad), block_q=64, block_k=64,
            bwd_impl=bwd_impl, interpret=True,
        )
        return jnp.sum(out * jnp.asarray(g))

    return [np.asarray(x) for x in jax.grad(f, argnums=(0, 1, 2))(q, k, v)]


def _port_grads(mask, q, k, v, g, pad, bwd_impl):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out, _ = port_flash.flash_attention(
        qt, kt, vt, mask, torch.from_numpy(pad), SCALE, bwd_impl
    )
    (out * torch.from_numpy(g)).sum().backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


@pytest.mark.parametrize("bwd_impl", ["fused", "split"])
def test_autograd_matches_jax_grad(bwd_impl):
    mask, q, k, v, g, pad = _case(0)
    assert q.shape[2] % 64 != 0
    before = dict(port_flash.bwd_launches)
    jg = _jax_grads(mask, q, k, v, g, pad, bwd_impl)
    pg = _port_grads(mask, q, k, v, g, pad, bwd_impl)
    assert port_flash.bwd_launches == before  # the plain version, no kernel
    for name, a, b in zip(("dq", "dk", "dv"), pg, jg):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, err_msg=name)
    dead = (mask[None] | pad[:, None, :]).all(axis=2)  # [B, T] dead query rows
    assert dead.any()
    for bi in range(q.shape[0]):
        assert (pg[0][bi][:, dead[bi]] == 0).all()
        assert (jg[0][bi][:, dead[bi]] == 0).all()
        for grad in pg[1:]:
            assert (grad[bi][:, pad[bi]] == 0).all()  # padded keys


def test_backward_wrapper_on_cpu_is_the_plain_version():
    mask, q, k, v, g, pad = _case(1)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    padt = torch.from_numpy(pad)
    out, lse = port_flash.flash_attention(*args, mask, padt, SCALE)
    do = torch.from_numpy(g)
    before = dict(port_flash.bwd_launches)
    ref = port_flash.flash_attention_bwd_reference(*args, mask, padt, out, lse, do, SCALE)
    for impl in ("fused", "split"):
        got = port_flash.flash_attention_backward(
            *args, mask, padt, out, lse, do, SCALE, impl
        )
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert port_flash.bwd_launches == before
    with pytest.raises(ValueError, match="bwd_impl"):
        port_flash.flash_attention(*args, mask, padt, SCALE, "dense")


def test_default_bwd_impl_is_read_at_each_call(monkeypatch):
    from mca_tpu_torch.ops.attention import masked_attention

    assert port_flash.default_bwd_impl == "fused"  # as in the JAX package
    mask, q, k, v, g, pad = _case(2)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    padt = torch.from_numpy(pad)
    monkeypatch.setattr(port_flash, "default_bwd_impl", "dense")
    with pytest.raises(ValueError, match="bwd_impl"):
        port_flash.flash_attention(*args, mask, padt, SCALE)
    with pytest.raises(ValueError, match="bwd_impl"):
        masked_attention(*args, scale=SCALE, attn_mask=mask,
                         key_padding_mask=padt, impl="pallas")
    port_flash.flash_attention(*args, mask, padt, SCALE, "split")  # named: kept


@pytest.mark.parametrize(
    "dims,fusion,combos",
    [([48, 30, 40], 14, [3, 2, 1]), ([800, 198, 800, 662], 88, [4, 3, 2])],
)
def test_kv_tile_schedule_matches_jax(dims, fusion, combos):
    mask = jax_masks.build_masks(dims, fusion, combos, fcl=True).attn_mask
    col_ptr, row_idx, full = port_flash.kv_tile_schedule(mask)
    _, _, _, q_kv, kv_kv, full_kv, _, nk = _tile_schedule(mask, 64, 64)
    assert len(col_ptr) == nk + 1
    cols = np.repeat(np.arange(nk), np.diff(col_ptr))
    np.testing.assert_array_equal(cols, kv_kv)
    np.testing.assert_array_equal(row_idx, q_kv)
    np.testing.assert_array_equal(full, full_kv)


@pytest.mark.parametrize("scale", [64**-0.5, 1.0, 0.1, 0.3])
def test_kv_kernels_q_operand_keeps_the_tpu_scale_rule(scale):
    """K2 / K3b compute s = q_s k^T and dk with q_s = bf16(q * bf16(scale))
    as the TPU kernels do.  Where bf16(scale) is a power of two they take
    q itself and scale s and dk in fp32, which gives the same numbers bit
    for bit; otherwise they take q_s from the wrapper and a unit scale."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(2, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    sq = port_flash._scale_q(scale, torch.bfloat16)
    q_s = q * torch.tensor(scale, dtype=torch.bfloat16)  # the TPU kernels' q_s
    q_in, scale_s = port_flash._q_operand(q, scale)
    power_of_two = scale in (64**-0.5, 1.0)
    if power_of_two:
        assert q_in is q and scale_s == sq
    else:
        assert scale_s == 1.0
        assert torch.equal(q_in, q_s)
    s_tpu = q_s.float() @ k.float().transpose(1, 2)
    s_kernel = (q_in.float() @ k.float().transpose(1, 2)) * scale_s
    assert torch.equal(s_kernel, s_tpu)
    assert torch.equal(q_in.float() * scale_s, q_s.float())


@pytest.mark.parametrize(
    "name,kind",
    [
        ("void (anonymous namespace)::flash_bwd_kv_kernel<true>(CUtensorMap_st, "
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
         "float const*, unsigned char const*, int const*, int const*, int const*, "
         "unsigned long const*, __nv_bfloat16*, __nv_bfloat16*, int, int, float, float)",
         "flash_bwd (K2)"),
        ("void (anonymous namespace)::flash_bwd_kv_kernel<false>(CUtensorMap_st, "
         "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
         "float const*, unsigned char const*, int const*, int const*, int const*, "
         "unsigned long const*, __nv_bfloat16*, __nv_bfloat16*, int, int, float, float)",
         "flash_bwd_dkv (K3b)"),
        ("void (anonymous namespace)::flash_bwd_dq_kernel(__nv_bfloat16 const*, "
         "__nv_bfloat16 const*, float const*, int, int, float, float)",
         "flash_bwd_dq (K3a)"),
        ("void (anonymous namespace)::flash_fwd_kernel(CUtensorMap_st, CUtensorMap_st, "
         "CUtensorMap_st, unsigned char const*, int const*, int const*, int const*, "
         "unsigned long const*, __nv_bfloat16*, float*, int, int, float)",
         "flash_fwd (K1)"),
        ("nvjet_tst_128x64_64x8_1x2_h_bz_TNT", "gemm (projections, FF, encoders, loss)"),
    ],
)
def test_profile_train_attributes_the_flash_kernels(name, kind):
    """``tools/profile_train`` sorts device time by kernel name: the
    kv-major template's two instances are K2 (with dq) and K3b."""
    from mca_tpu_torch.tools.profile_train import kind_of

    assert kind_of(name) == kind
