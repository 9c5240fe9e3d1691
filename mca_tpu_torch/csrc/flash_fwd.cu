// Block-sparse masked flash attention, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::_fwd_kernel
// (launched through pl.pallas_call in make_flash_attention's _fwd_call).
//
// What it computes, exactly as _fwd_kernel does:
//   - q, k, v: [B*H, T, 64] bf16, contiguous; out [B*H, T, 64] bf16 and
//     lse [B*H, T] fp32;
//   - a static [T, T] mask (1 = blocked) shared by batch and heads, and a
//     dynamic [B, T] key padding mask (1 = padded key), both uint8;
//   - the softmax scale folded into the q tile (in bf16), fp32 scores,
//     fp32 running max and sum, p rounded to bf16 for the p.v product
//     with fp32 accumulation;
//   - the running max floored at DEAD_CLAMP = -1e29, so a fully masked
//     row gives p = 0 everywhere; such rows return out = 0 and
//     lse = NEG_INF (-1e30).
//
// Design.  The TPU kernel walks a sequential (bh, tile) grid and carries
// the online-softmax state in scratch from one grid step to the next.
// Here one thread block owns one (64-row q tile, b*h) pair and loops
// over that q tile's row of a CSR tile schedule (row_ptr / col_idx /
// full, built once per static mask on the host), so the carry lives in
// the block's shared memory and the blocks run in parallel.  Tiles the
// mask blocks entirely are never visited; on tiles whose `full` flag is
// set the static mask is not read at all.  The key padding is read as
// the [B, T] bytes themselves (the TPU's [B, 8, T] broadcast existed
// only for its sublane minimum), and the ragged edge (T = 2548 is not a
// multiple of 64) is masked here, so the host makes no padded copies.
//
// Each of the 4 warps owns 16 q rows and keeps everything about them in
// registers, as FlashAttention-2 does: its q fragments (loaded once),
// the S tile of the current kv tile as mma.sync m16n8k16 accumulators,
// the running max and sum, and the fp32 O accumulator.  The masks are
// applied and the online softmax computed on the S accumulators in
// place (a row's 64 entries sit in the 4 threads of a quad, so a row
// reduction is two shuffles); the probabilities, rounded to bf16, are
// then exactly the A fragments of the p v product, so S and p never
// touch shared memory.  Per tile only k (row-major), v (stored
// transposed, so its B fragments are 32-bit loads), the mask tile
// unless the tile is full, and the padding bytes pass through shared
// memory.

// Bound on this card: at TCGA_config1 (B 8, H 8, T 2548) the static mask
// leaves 1.9e6 of the 6.5e6 score entries per (b, h), fewer after key
// padding: about 24 GFLOP per layer for both products (24 us at 989
// TFLOP/s bf16), while q, k, v and out are 84 MB (25 us at 3.35 TB/s).
// The two bounds are close; chip_smoke.py computes both for its inputs.
// This kernel issues mma.sync (not wgmma) and copies k and v with
// plain loads, so it runs far from either; wgmma and TMA are later
// work.

#include "flash_common.cuh"

namespace {

// q, k and v^T tiles (bf16) + the mask tile and the per-column flags
constexpr size_t kSmemBytes = 3 * kTileH + kMaskBytes + kBlock;

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ mask,
                 const uint8_t* __restrict__ pad, const int* __restrict__ row_ptr,
                 const int* __restrict__ col_idx, const int* __restrict__ full,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int heads, int t,
                 float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + kBlock * kLdh;
  __nv_bfloat16* vt = ks + kBlock * kLdh;  // v^T: [d][key]
  uint8_t* mask_s = reinterpret_cast<uint8_t*>(vt + kD * kLdh);
  uint8_t* colblk = mask_s + kMaskBytes;

  const int qb = blockIdx.x, bh = blockIdx.y;
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3);  // fragment row, first column
  const int r0 = warp * 16;                      // this warp's first row within the tile
  const size_t head_off = size_t(bh) * t * kD;
  const uint8_t* pad_b = pad ? pad + size_t(bh / heads) * t : nullptr;

  load_tile(qs, q + head_off, q0, t, scale);
  __syncthreads();
  uint32_t qa[kD / 16][4];  // this warp's q as A fragments, one per 16-wide k step
  load_a_frags(qa, qs, r0, g, c2);

  // rows g and g + 8 of the warp: running max, this thread's share of
  // the running sum, and O (8 column blocks of 8, d0..d3 layout)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[kD / 8][4];
  zero_acc(o);

  for (int it = row_ptr[qb]; it < row_ptr[qb + 1]; ++it) {
    const int k0 = col_idx[it] * kBlock;
    const bool tile_full = full[it] != 0;
    __syncthreads();  // all warps are done with the previous tile
    load_tile(ks, k + head_off, k0, t, 1.f);
    load_tile_transposed(vt, v + head_off, k0, t);
    // the tile's mask bytes: a key past t or padded blocks its column;
    // the static mask (rows or columns past t blocked) only where the
    // tile is not full
    if (threadIdx.x < kBlock) {
      const int j = k0 + threadIdx.x;
      colblk[threadIdx.x] = j >= t || (pad_b != nullptr && pad_b[j] != 0);
    }
    if (!tile_full) load_mask_tile(mask_s, mask, q0, k0, t);
    __syncthreads();

    // S = (scale q) k^T: 8 blocks of 8 keys
    float s[kBlock / 8][4];
    zero_acc(s);
    mma_a_bt(s, qa, ks, g, c2);

    // masks, then the online softmax on the accumulators in place
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + (e >> 1) * 8, c = nb * 8 + c2 + (e & 1);
        if (colblk[c] || (!tile_full && mask_s[row * kLdm + c])) s[nb][e] = kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(fmaxf(m_run[h], quad_max(mx[h])), kDeadClamp);
      corr[h] = exp2f((m_run[h] - m_new) * kLog2e);
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nb][e] - m_run[e >> 1]) * kLog2e);
        s[nb][e] = p;
        l_run[e >> 1] += p;
      }
      o[nb][0] *= corr[0];
      o[nb][1] *= corr[0];
      o[nb][2] *= corr[1];
      o[nb][3] *= corr[1];
    }

    // O += p v: the probabilities of key blocks 2j and 2j + 1, rounded
    // to bf16, are the A fragment of the j-th 16-key step
    mma_acc_b(o, s, vt, g, c2);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qrow = q0 + r0 + g + 8 * h;
    const float l = quad_sum(l_run[h]);
    if (qrow >= t) continue;
    __nv_bfloat16* orow = out + head_off + size_t(qrow) * kD;
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      const float x0 = l > 0.f ? o[nb][2 * h] / l : 0.f;
      const float x1 = l > 0.f ? o[nb][2 * h + 1] / l : 0.f;
      *reinterpret_cast<uint32_t*>(orow + nb * 8 + c2) = pack_bf16(x0, x1);
    }
    if ((lane & 3) == 0) lse[size_t(bh) * t + qrow] = l > 0.f ? m_run[h] + logf(l) : kNegInf;
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out: [bh, t, 64] bf16; lse: [bh, t] fp32; mask: [t, t] uint8;
// pad: [bh / heads, t] uint8 or null; row_ptr: [n_qblocks + 1] int32;
// col_idx, full: [row_ptr[n_qblocks]] int32.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int mca_flash_fwd(const void* q, const void* k, const void* v, const void* mask,
                             const void* pad, const void* row_ptr, const void* col_idx,
                             const void* full, void* out, void* lse, int bh, int heads, int t,
                             int n_qblocks, float scale, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_qblocks, bh);
  flash_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(pad), static_cast<const int*>(row_ptr),
      static_cast<const int*>(col_idx), static_cast<const int*>(full),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), heads, t, scale);
  return int(cudaGetLastError());
}
