// The mma.sync building blocks of the overlap probe's control (K8,
// through mma_chain.cuh): m16n8k16 products on register fragments.  The tile
// geometry and constants come from flash_tile.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tile.cuh"

namespace {

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

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) acc[nb][0] = acc[nb][1] = acc[nb][2] = acc[nb][3] = 0.f;
}

}  // namespace
