// Building blocks of the mma.sync kernels: K3a (flash_bwd_dq.cu) and,
// through mma_chain.cuh, the measurement kernels K6-K8: mma.sync
// m16n8k16 fragments and the tile loaders (row-major, transposed, or both
// from one global read).  The tile geometry, softmax constants and quad
// reductions come from flash_tile.cuh.
//
// Tiles live in shared memory as bf16 rows of kLdh = 72 elements (64 +
// 8 of padding, so the 32-bit fragment loads of the 8 rows a quad
// touches fall in distinct banks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

constexpr int kWarps = 4;              // each warp owns 16 rows of the tile
constexpr int kThreads = kWarps * 32;
constexpr int kLdh = kD + 8;           // bf16 row stride of the shared tiles
constexpr int kLdm = kBlock + 4;       // byte row stride of the mask tile

constexpr size_t kTileH = size_t(kBlock) * kLdh * sizeof(__nv_bfloat16);
constexpr size_t kMaskBytes = size_t(kBlock) * kLdm;

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

// 16 bytes (8 values) of row `row` of a [t, 64] bf16 matrix at column
// c; zero for rows at or past t.  With `scale` != 1 each value is
// multiplied and rounded to bf16, as the TPU kernels' q * scale in the
// input dtype.
__device__ __forceinline__ uint4 load_row8(const __nv_bfloat16* src, int row, int c, int t,
                                           float scale) {
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (row < t) {
    val = *reinterpret_cast<const uint4*>(src + size_t(row) * kD + c);
    if (scale != 1.f) {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        h[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
    }
  }
  return val;
}

// Rows [row0, row0 + 64) of a [t, 64] bf16 matrix into shared memory
// (row stride kLdh), 16 bytes per thread and step; rows at or past t are
// zero.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int t, float scale) {
  for (int i = threadIdx.x; i < kBlock * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * kLdh + c) = load_row8(src, row0 + r, c, t, scale);
  }
}

// The same rows stored transposed, dst[d][row] (row stride kLdh), and,
// when `dst_rows` is not null, also row-major there: one global read
// feeds both copies.  Neighbouring threads take neighbouring rows, so
// the transposed stores do not conflict.
__device__ __forceinline__ void load_tile_transposed(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                     int row0, int t, float scale = 1.f,
                                                     __nv_bfloat16* dst_rows = nullptr) {
  for (int i = threadIdx.x; i < kBlock * (kD / 8); i += kThreads) {
    const int r = i % kBlock, c = (i / kBlock) * 8;
    const uint4 val = load_row8(src, row0 + r, c, t, scale);
    if (dst_rows != nullptr) *reinterpret_cast<uint4*>(dst_rows + r * kLdh + c) = val;
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kLdh + r] = h[j];
  }
}

// The [64 x 64] block of the static mask at (q0, k0) into shared memory
// (row stride kLdm, rows = queries); rows or columns past t count as
// blocked.
__device__ __forceinline__ void load_mask_tile(uint8_t* dst, const uint8_t* mask, int q0, int k0,
                                               int t) {
  for (int i = threadIdx.x; i < kBlock * kBlock; i += kThreads) {
    const int r = i / kBlock, c = i % kBlock, qrow = q0 + r, j = k0 + c;
    dst[r * kLdm + c] = (qrow >= t || j >= t) ? 1 : mask[size_t(qrow) * t + j];
  }
}

// A fragments (one per 16-wide step of the head dim) of this warp's 16
// rows of a row-major shared tile.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kD / 16][4], const __nv_bfloat16* tile,
                                             int r0, int g, int c2) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const __nv_bfloat16* p = tile + (r0 + g) * kLdh + kk * 16 + c2;
    a[kk][0] = ld32(p);
    a[kk][1] = ld32(p + 8 * kLdh);
    a[kk][2] = ld32(p + 8);
    a[kk][3] = ld32(p + 8 * kLdh + 8);
  }
}

// acc[16 x 64] += A[16 x 64] * B^T, A as register fragments, B as 64
// rows of a row-major shared tile (b0 = B[n][2c..2c+1], contiguous).
__device__ __forceinline__ void mma_a_bt(float (&acc)[kBlock / 8][4],
                                         const uint32_t (&a)[kD / 16][4],
                                         const __nv_bfloat16* b_rows, int g, int c2) {
#pragma unroll
  for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const __nv_bfloat16* p = b_rows + (nb * 8 + g) * kLdh + kk * 16 + c2;
      mma16816(acc[nb], a[kk][0], a[kk][1], a[kk][2], a[kk][3], ld32(p), ld32(p + 8));
    }
  }
}

// acc[16 x 64] += X[16 x 64] * B, X given as fp32 accumulators in the
// d0..d3 layout (rounded to bf16 here: the accumulators of key blocks
// 2j and 2j + 1 are exactly the A fragment of the j-th 16-wide step),
// B as its transpose in shared memory (bt[n][k], so b0 is contiguous).
__device__ __forceinline__ void mma_acc_b(float (&acc)[kD / 8][4], const float (&x)[kBlock / 8][4],
                                          const __nv_bfloat16* bt, int g, int c2) {
#pragma unroll
  for (int j = 0; j < kBlock / 16; ++j) {
    const uint32_t a0 = pack_bf16(x[2 * j][0], x[2 * j][1]);
    const uint32_t a1 = pack_bf16(x[2 * j][2], x[2 * j][3]);
    const uint32_t a2 = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      const __nv_bfloat16* p = bt + (nb * 8 + g) * kLdh + j * 16 + c2;
      mma16816(acc[nb], a0, a1, a2, a3, ld32(p), ld32(p + 8));
    }
  }
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
}

}  // namespace
