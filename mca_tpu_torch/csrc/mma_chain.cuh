// The chained 256-wide product shared by the measurement kernels: the
// roofline counter's `big` body (roofline_counter.cu), the overlap
// probe's matrix chain (probe_overlap.cu) and its control
// (probe_overlap_ctl.cu).
//
// A block of kChainWarps warps holds a [kChainRows x 256] bf16 operand
// `a`, 16 rows per warp, as mma.sync A fragments in registers, and W
// [256 x 256] bf16 in shared memory, stored transposed (row stride
// kLdw = 264, so the 32-bit B-fragment loads of a quad's 8 rows fall in
// distinct banks).  One step is a <- epi(a W, a): per warp 4 column
// chunks of 64, each 16 k-steps of 8 m16n8k16 products (512 HMMA per
// warp and step), the chunk's fp32 accumulators turned into the new A
// fragments of the same 64 columns (an output column block of 16 is
// exactly the A fragment of that k-step, as in flash_common.cuh's
// mma_acc_b).  `between` runs after every fourth k-step (16 times a
// step): the overlap probe puts its exp chain there, in the same
// instruction stream.
//
// Why 256: W^T takes 135,168 bytes of shared memory, and a warp's 16 x
// 256 operand, its 16 x 256 successor and one chunk's accumulators take
// 160 registers a thread; a 320-wide W (211 KB) would leave no room for
// the accumulators under the 255-register limit of a 256-thread block.

#pragma once

#include "flash_common.cuh"

namespace {

constexpr int kChainW = 256;                 // width and depth of the chained product
constexpr int kChainWarps = 8;
constexpr int kChainThreads = kChainWarps * 32;
constexpr int kChainRows = kChainWarps * 16;  // rows of `a` a block holds
constexpr int kLdw = kChainW + 8;             // bf16 row stride of W^T in shared memory
constexpr size_t kWBytes = size_t(kChainW) * kLdw * sizeof(__nv_bfloat16);

// W [256 x 256] (row-major: k, n) from global memory into shared memory
// as W^T [n][k]; neighbouring threads take neighbouring k.
__device__ __forceinline__ void load_w_transposed(__nv_bfloat16* wt, const __nv_bfloat16* w) {
  for (int i = threadIdx.x; i < kChainW * kChainW / 8; i += blockDim.x) {
    const int k = i % kChainW, n0 = (i / kChainW) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(w + size_t(k) * kChainW + n0);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) wt[(n0 + j) * kLdw + k] = h[j];
  }
}

// This warp's 16 rows (r0..r0 + 15) of a [rows x 256] bf16 matrix as A
// fragments, straight from global memory, and back.
__device__ __forceinline__ void load_a256(uint32_t (&a)[kChainW / 16][4], const __nv_bfloat16* src,
                                          int r0, int g, int c2) {
#pragma unroll
  for (int kk = 0; kk < kChainW / 16; ++kk) {
    const __nv_bfloat16* p = src + size_t(r0 + g) * kChainW + kk * 16 + c2;
    a[kk][0] = ld32(p);
    a[kk][1] = ld32(p + 8 * kChainW);
    a[kk][2] = ld32(p + 8);
    a[kk][3] = ld32(p + 8 * kChainW + 8);
  }
}

__device__ __forceinline__ void store_a256(__nv_bfloat16* dst, const uint32_t (&a)[kChainW / 16][4],
                                           int r0, int g, int c2) {
#pragma unroll
  for (int kk = 0; kk < kChainW / 16; ++kk) {
    __nv_bfloat16* p = dst + size_t(r0 + g) * kChainW + kk * 16 + c2;
    *reinterpret_cast<uint32_t*>(p) = a[kk][0];
    *reinterpret_cast<uint32_t*>(p + 8 * kChainW) = a[kk][1];
    *reinterpret_cast<uint32_t*>(p + 8) = a[kk][2];
    *reinterpret_cast<uint32_t*>(p + 8 * kChainW + 8) = a[kk][3];
  }
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// a <- epi(a W, a).  epi(x_lo, x_hi, old) takes two fp32 entries of
// a W and the packed pair of a they replace, and returns the new pair.
template <class Epi, class Between>
__device__ __forceinline__ void chain_step(uint32_t (&a)[kChainW / 16][4], const __nv_bfloat16* wt,
                                           int g, int c2, Epi epi, Between between) {
  uint32_t an[kChainW / 16][4];
#pragma unroll
  for (int ch = 0; ch < kChainW / 64; ++ch) {
    float acc[8][4];
    zero_acc(acc);
#pragma unroll
    for (int kk = 0; kk < kChainW / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        const __nv_bfloat16* p = wt + (ch * 64 + nb * 8 + g) * kLdw + kk * 16 + c2;
        mma16816(acc[nb], a[kk][0], a[kk][1], a[kk][2], a[kk][3], ld32(p), ld32(p + 8));
      }
      if ((kk & 3) == 3) between();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = ch * 4 + j;  // output columns kk*16.. : accumulator blocks 2j, 2j + 1
      an[kk][0] = epi(acc[2 * j][0], acc[2 * j][1], a[kk][0]);
      an[kk][1] = epi(acc[2 * j][2], acc[2 * j][3], a[kk][1]);
      an[kk][2] = epi(acc[2 * j + 1][0], acc[2 * j + 1][1], a[kk][2]);
      an[kk][3] = epi(acc[2 * j + 1][2], acc[2 * j + 1][3], a[kk][3]);
    }
  }
#pragma unroll
  for (int kk = 0; kk < kChainW / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = an[kk][e];
  }
}

// The overlap probe's matrix chain, a <- bf16(0.999 * (a W)).
struct DecayEpi {
  __device__ __forceinline__ uint32_t operator()(float x0, float x1, uint32_t) const {
    return pack_bf16(0.999f * x0, 0.999f * x1);
  }
};

struct Nothing {
  __device__ __forceinline__ void operator()() const {}
};

// 2^x on the MUFU (one MUFU.EX2, denormals flushed)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Set the dynamic shared-memory limit of `kernel` and report how many of
// its blocks of `threads` fit on one SM at `smem` bytes, times the SMs.
__host__ inline cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                                            int* blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  *blocks = sms * per_sm;
  return err;
}

}  // namespace
