// The kv-major flash-attention backward, shared by K2 (flash_bwd.cu:
// dk, dv and dq in one pass) and K3b (flash_bwd_dkv.cu: dk and dv
// only).  What it computes, exactly as the TPU kernels _fused_bwd_kernel
// and _dkv_kernel (mca_tpu/ops/flash_attention.py) do:
//
//   q_s = bf16(q * scale)                      (scale folded into q)
//   s   = q_s k^T in fp32, blocked entries -> p = 0
//   p   = exp(s - max(lse, DEAD_CLAMP))        (fp32; dead rows give 0)
//   dv += bf16(p)^T do                         (fp32 accumulation)
//   dp  = do v^T                               (fp32)
//   ds  = p * (dp - delta)                     (delta = rowsum(do * out))
//   dk += bf16(ds)^T q_s                       (scale absorbed by q_s)
//   dq += scale * bf16(ds) k                   (K2 only)
//
// Design.  One thread block owns one (64-key kv tile, b*h) pair and
// walks that tile's column of the kv-major CSR tile schedule (col_ptr /
// row_idx / full), the loop taking the place of the TPU's sequential
// grid.  Each of the 4 warps owns 16 keys and keeps their k and v as
// A fragments and their dk and dv as fp32 mma accumulators in
// registers for the whole walk; both are written once, as bf16, at the
// end.  Per q tile it computes the transposed scores s^T = k q_s^T, so
// the probabilities and ds come out as accumulators of the warp's own
// keys and feed the dv and dk products as A fragments without leaving
// registers.  q_s and do pass through shared memory twice each, row-
// major and transposed (one global read feeds both), so every B
// fragment is a 32-bit load.
//
// dq sums over keys, which the warps split among themselves, and over
// kv tiles, which blocks split among themselves in no order.  K2 writes
// ds (bf16) to shared memory, each warp multiplies 16 of its q rows by
// k (stored transposed), and adds the fp32 partial to a zeroed
// [B*H, T, 64] fp32 buffer with atomicAdd; the wrapper casts it to
// bf16.  The order of those sums changes from run to run (K3a, the
// q-major dq kernel, is the deterministic alternative).
//
// Key padding and the ragged edge are read per key once per block (a
// key's row of s^T is either all blocked or not); the static mask tile
// is read only on tiles whose `full` flag is clear.

#pragma once

#include "flash_common.cuh"

namespace {

// shared memory: q_s, q_s^T, do, do^T; with dq also k^T and ds; then
// the mask tile and lse / delta of the tile's 64 q rows
template <bool kWithDq>
constexpr size_t bwd_kv_smem_bytes() {
  return (kWithDq ? 6 : 4) * kTileH + kMaskBytes + 2 * kBlock * sizeof(float);
}

template <bool kWithDq>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ pad,
                    const int* __restrict__ col_ptr, const int* __restrict__ row_idx,
                    const int* __restrict__ full, float* __restrict__ dq_acc,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int heads,
                    int t, float scale_q, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [q][d]
  __nv_bfloat16* qt = qs + kBlock * kLdh;                      // [d][q]
  __nv_bfloat16* dos = qt + kD * kLdh;                         // [q][d]
  __nv_bfloat16* dot = dos + kBlock * kLdh;                    // [d][q]
  __nv_bfloat16* kt = dot + kD * kLdh;                         // [d][key] (dq only)
  __nv_bfloat16* dss = kWithDq ? kt + kD * kLdh : kt;          // [q][key] (dq only)
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(kWithDq ? dss + kBlock * kLdh : kt);
  float* lse_s = reinterpret_cast<float*>(mask_s + kMaskBytes);
  float* delta_s = lse_s + kBlock;

  const int kb = blockIdx.x, bh = blockIdx.y;
  const int k0 = kb * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // fragment row, first column
  const int r0 = warp * 16;                      // this warp's first key within the tile
  const size_t head_off = size_t(bh) * t * kD;
  const uint8_t* pad_b = pad ? pad + size_t(bh / heads) * t : nullptr;

  // this warp's k and v as A fragments, through the q_s / do buffers
  // (free until the walk starts); k^T stays for the dq product
  if constexpr (kWithDq) {
    load_tile_transposed(kt, k + head_off, k0, t, 1.f, qs);
  } else {
    load_tile(qs, k + head_off, k0, t, 1.f);
  }
  load_tile(dos, v + head_off, k0, t, 1.f);
  __syncthreads();
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_a_frags(ka, qs, r0, g, c2);
  load_a_frags(va, dos, r0, g, c2);

  // keys g and g + 8 of the warp: past t or padded blocks the whole row
  bool keyblk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int j = k0 + r0 + g + 8 * h;
    keyblk[h] = j >= t || (pad_b != nullptr && pad_b[j] != 0);
  }

  float dk_acc[kD / 8][4], dv_acc[kD / 8][4];
  zero_acc(dk_acc);
  zero_acc(dv_acc);

  for (int it = col_ptr[kb]; it < col_ptr[kb + 1]; ++it) {
    const int q0 = row_idx[it] * kBlock;
    const bool tile_full = full[it] != 0;
    __syncthreads();  // all warps are done with the previous q tile
    load_tile_transposed(qt, q + head_off, q0, t, scale_q, qs);
    load_tile_transposed(dot, dout + head_off, q0, t, 1.f, dos);
    if (threadIdx.x < kBlock) {
      const int qrow = q0 + threadIdx.x;
      const bool in = qrow < t;
      lse_s[threadIdx.x] = in ? fmaxf(lse[size_t(bh) * t + qrow], kDeadClamp) : 0.f;
      delta_s[threadIdx.x] = in ? delta[size_t(bh) * t + qrow] : 0.f;
    }
    if (!tile_full) load_mask_tile(mask_s, mask, q0, k0, t);
    __syncthreads();

    // s^T = k q_s^T: rows = this warp's keys, 8 blocks of 8 queries;
    // then p^T in place (blocked entries 0)
    float p[kBlock / 8][4];
    zero_acc(p);
    mma_a_bt(p, ka, qs, g, c2);
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + (e >> 1) * 8, c = nb * 8 + c2 + (e & 1);
        const bool blocked = keyblk[e >> 1] || (!tile_full && mask_s[c * kLdm + key]);
        p[nb][e] = blocked ? 0.f : exp2f((p[nb][e] - lse_s[c]) * kLog2e);
      }
    }

    // dv += p^T do
    mma_acc_b(dv_acc, p, dot, g, c2);

    // dp^T = v do^T, then ds^T = p^T (dp^T - delta) in place
    float ds[kBlock / 8][4];
    zero_acc(ds);
    mma_a_bt(ds, va, dos, g, c2);
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nb * 8 + c2 + (e & 1);
        ds[nb][e] = p[nb][e] * (ds[nb][e] - delta_s[c]);
      }
    }

    // dk += ds^T q_s
    mma_acc_b(dk_acc, ds, qt, g, c2);

    if constexpr (kWithDq) {
      // ds (bf16) to shared memory as [q][key], then each warp takes 16
      // q rows: dq_partial = scale * ds k, added to the fp32 buffer
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = r0 + g + (e >> 1) * 8, c = nb * 8 + c2 + (e & 1);
          dss[c * kLdh + key] = __float2bfloat16_rn(ds[nb][e]);
        }
      }
      __syncthreads();
      uint32_t dsa[kBlock / 16][4];
      load_a_frags(dsa, dss, r0, g, c2);
      float dq[kD / 8][4];
      zero_acc(dq);
      mma_a_bt(dq, dsa, kt, g, c2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int qrow = q0 + r0 + g + 8 * h;
        if (qrow >= t) continue;
        float* dst = dq_acc + head_off + size_t(qrow) * kD;
#pragma unroll
        for (int nb = 0; nb < kD / 8; ++nb) {
          atomicAdd(dst + nb * 8 + c2, scale * dq[nb][2 * h]);
          atomicAdd(dst + nb * 8 + c2 + 1, scale * dq[nb][2 * h + 1]);
        }
      }
    }
  }

  // dk, dv of this warp's keys, once, as bf16 (padded keys come out 0)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + r0 + g + 8 * h;
    if (key >= t) continue;
    __nv_bfloat16* dkrow = dk + head_off + size_t(key) * kD;
    __nv_bfloat16* dvrow = dv + head_off + size_t(key) * kD;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(dkrow + nb * 8 + c2) =
          pack_bf16(dk_acc[nb][2 * h], dk_acc[nb][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvrow + nb * 8 + c2) =
          pack_bf16(dv_acc[nb][2 * h], dv_acc[nb][2 * h + 1]);
    }
  }
}

}  // namespace
