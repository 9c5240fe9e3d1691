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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;                 // head dim (compile-time)
constexpr int kBlock = 64;             // q rows and kv columns per tile
constexpr int kWarps = 4;              // each warp owns 16 q rows
constexpr int kThreads = kWarps * 32;
constexpr int kLdh = kD + 8;           // bf16 row stride of the q, k, v^T tiles
constexpr int kLdm = kBlock + 4;       // byte row stride of the mask tile
constexpr float kNegInf = -1e30f;
constexpr float kDeadClamp = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr size_t kTileH = size_t(kBlock) * kLdh * sizeof(__nv_bfloat16);
// q, k and v^T tiles (bf16) + the mask tile and the per-column flags
constexpr size_t kSmemBytes = 3 * kTileH + kBlock * kLdm + kBlock;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
// Fragments (PTX ISA, mma.m16n8k16), g = lane / 4, c = lane % 4:
//   a0: A[g][2c..2c+1]  a1: A[g+8][2c..]  a2: A[g][2c+8..]  a3: A[g+8][2c+8..]
//   b0: B[2c..2c+1][g]  b1: B[2c+8..2c+9][g]
//   d0, d1: D[g][2c], D[g][2c+1]   d2, d3: D[g+8][2c], D[g+8][2c+1]
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Rows [row0, row0 + 64) of a [t, 64] bf16 matrix into shared memory
// (row stride kLdh), 16 bytes per thread and step; rows at or past t are
// zero.  With `scale` != 1 each value is multiplied and rounded to bf16,
// as the TPU kernel's q * scale in the input dtype.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int t, float scale) {
  for (int i = threadIdx.x; i < kBlock * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) {
      val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * kD + c);
      if (scale != 1.f) {
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = val;
  }
}

// The same rows of v stored transposed, dst[d][key] (row stride kLdh);
// neighbouring threads take neighbouring keys, so the stores do not
// conflict.
__device__ __forceinline__ void load_tile_transposed(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* src, int row0,
                                                     int t) {
  for (int i = threadIdx.x; i < kBlock * (kD / 8); i += kThreads) {
    const int r = i % kBlock, c = (i / kBlock) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < t) val = *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * kD + c);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kLdh + r] = h[j];
  }
}

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
  uint8_t* colblk = mask_s + kBlock * kLdm;

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
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const __nv_bfloat16* p = qs + (r0 + g) * kLdh + kk * 16 + c2;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * kLdh);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * kLdh + 8);
  }

  // rows g and g + 8 of the warp: running max, this thread's share of
  // the running sum, and O (8 column blocks of 8, d0..d3 layout)
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  float o[kD / 8][4];
#pragma unroll
  for (int nb = 0; nb < kD / 8; ++nb) o[nb][0] = o[nb][1] = o[nb][2] = o[nb][3] = 0.f;

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
    if (!tile_full) {
      for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
        const int r = i / kBlock, c = i % kBlock, qrow = q0 + r, j = k0 + c;
        mask_s[r * kLdm + c] = (qrow >= t || j >= t) ? 1 : mask[size_t(qrow) * t + j];
      }
    }
    __syncthreads();

    // S = (scale q) k^T: 8 blocks of 8 keys
    float s[kBlock / 8][4];
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const __nv_bfloat16* p = ks + (nb * 8 + g) * kLdh + kk * 16 + c2;
        mma16816(s[nb], qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], ld32(p), ld32(p + 8));
      }
    }

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
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j) {
      const uint32_t a0 = pack_bf16(s[2 * j][0], s[2 * j][1]);
      const uint32_t a1 = pack_bf16(s[2 * j][2], s[2 * j][3]);
      const uint32_t a2 = pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        const __nv_bfloat16* p = vt + (nb * 8 + g) * kLdh + j * 16 + c2;
        mma16816(o[nb], a0, a1, a2, a3, ld32(p), ld32(p + 8));
      }
    }
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
