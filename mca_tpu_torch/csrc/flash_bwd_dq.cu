// Block-sparse masked flash attention, backward dq (K3a), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::_dq_kernel
// (the first pl.pallas_call of make_flash_attention's split _bwd_call):
// the q-major half of the split backward, with K3b (flash_bwd_dkv.cu)
// computing dk and dv.  What it computes, exactly as _dq_kernel does:
//
//   q_s = bf16(q * scale); s = q_s k^T (fp32), blocked entries -> p = 0
//   p   = exp(s - max(lse, DEAD_CLAMP)); dp = do v^T
//   ds  = p * (dp - delta); dq = scale * sum over kv tiles of bf16(ds) k
//
// Design.  One thread block owns one (64-row q tile, b*h) pair and walks
// that tile's row of the q-major CSR schedule (the forward's), so dq
// sums in fp32 registers in a fixed order and is written once as bf16:
// no atomics, the same result on every run.  Each of the 4 warps owns
// 16 q rows and keeps their q_s and do as A fragments, and lse and delta
// of its rows, in registers.  Per kv tile, k passes through shared
// memory row-major (the B operand of s) and transposed (the B operand of
// dq), v row-major (the B operand of dp); ds stays in registers between
// its product and the next.
//
// Bound on this card: three products of depth 64 per live score entry
// (s, dp, dq); at TCGA_config1 ~3.5e10 FLOP per layer, 35 us at 989
// TFLOP/s bf16, against ~126 MB of q, k, v, do read and dq written (38
// us at 3.35 TB/s): the two bounds are close.  The same mma.sync design
// as K1; wgmma and TMA are later work.

#include "flash_common.cuh"

namespace {

// k, k^T and v tiles, then the mask tile and the per-column flags
constexpr size_t kSmemBytes = 3 * kTileH + kMaskBytes + kBlock;

__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, const uint8_t* __restrict__ pad,
                    const int* __restrict__ row_ptr, const int* __restrict__ col_idx,
                    const int* __restrict__ full, __nv_bfloat16* __restrict__ dq, int heads,
                    int t, float scale_q, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [key][d]
  __nv_bfloat16* kt = ks + kBlock * kLdh;                       // [d][key]
  __nv_bfloat16* vs = kt + kD * kLdh;                           // [key][d]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(vs + kBlock * kLdh);
  uint8_t* colblk = mask_s + kMaskBytes;

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // fragment row, first column
  const int r0 = warp * 16;                      // this warp's first row within the tile
  const size_t head_off = size_t(bh) * t * kD;
  const uint8_t* pad_b = pad ? pad + size_t(bh / heads) * t : nullptr;

  // this warp's q_s and do as A fragments, through the k / v buffers
  load_tile(ks, q + head_off, q0, t, scale_q);
  load_tile(vs, dout + head_off, q0, t, 1.f);
  __syncthreads();
  uint32_t qa[kD / 16][4], doa[kD / 16][4];
  load_a_frags(qa, ks, r0, g, c2);
  load_a_frags(doa, vs, r0, g, c2);

  // rows g and g + 8 of the warp: lse (floored, so dead rows give p = 0)
  // and delta; rows past t are blocked by the mask tile
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qrow = q0 + r0 + g + 8 * h;
    const bool in = qrow < t;
    lse_r[h] = in ? fmaxf(lse[size_t(bh) * t + qrow], kDeadClamp) : 0.f;
    delta_r[h] = in ? delta[size_t(bh) * t + qrow] : 0.f;
  }

  float dq_acc[kD / 8][4];
  zero_acc(dq_acc);

  for (int it = row_ptr[qb]; it < row_ptr[qb + 1]; ++it) {
    const int k0 = col_idx[it] * kBlock;
    const bool tile_full = full[it] != 0;
    __syncthreads();  // all warps are done with the previous tile
    load_tile_transposed(kt, k + head_off, k0, t, 1.f, ks);
    load_tile(vs, v + head_off, k0, t, 1.f);
    if (threadIdx.x < kBlock) {
      const int j = k0 + threadIdx.x;
      colblk[threadIdx.x] = j >= t || (pad_b != nullptr && pad_b[j] != 0);
    }
    if (!tile_full) load_mask_tile(mask_s, mask, q0, k0, t);
    __syncthreads();

    // s = q_s k^T, then p in place (blocked entries 0)
    float p[kBlock / 8][4];
    zero_acc(p);
    mma_a_bt(p, qa, ks, g, c2);
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e >> 1) * 8, c = nb * 8 + c2 + (e & 1);
        const bool blocked = colblk[c] || (!tile_full && mask_s[row * kLdm + c]);
        p[nb][e] = blocked ? 0.f : exp2f((p[nb][e] - lse_r[e >> 1]) * kLog2e);
      }
    }

    // dp = do v^T, then ds = p (dp - delta) in place
    float ds[kBlock / 8][4];
    zero_acc(ds);
    mma_a_bt(ds, doa, vs, g, c2);
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nb][e] = p[nb][e] * (ds[nb][e] - delta_r[e >> 1]);
    }

    // dq += ds k
    mma_acc_b(dq_acc, ds, kt, g, c2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qrow = q0 + r0 + g + 8 * h;
    if (qrow >= t) continue;
    __nv_bfloat16* dqrow = dq + head_off + size_t(qrow) * kD;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      *reinterpret_cast<uint32_t*>(dqrow + nb * 8 + c2) =
          pack_bf16(scale * dq_acc[nb][2 * h], scale * dq_acc[nb][2 * h + 1]);
    }
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, dout, dq: [bh, t, 64] bf16; lse, delta: [bh, t] fp32; mask:
// [t, t] uint8; pad: [bh / heads, t] uint8 or null; row_ptr:
// [n_qblocks + 1] int32; col_idx, full: [row_ptr[n_qblocks]] int32.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int mca_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* mask,
                                const void* pad, const void* row_ptr, const void* col_idx,
                                const void* full, void* dq, int bh, int heads, int t,
                                int n_qblocks, float scale_q, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_qblocks, bh);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(pad),
      static_cast<const int*>(row_ptr), static_cast<const int*>(col_idx),
      static_cast<const int*>(full), static_cast<__nv_bfloat16*>(dq), heads, t, scale_q, scale);
  return int(cudaGetLastError());
}
