// Fused GEGLU feed-forward, forward, for Hopper (sm_90a).
//
// Replaces the TPU kernel mca_tpu/ops/fused_ff.py::_ff_kernel
// (launched through pl.pallas_call in _ff_local).
//
// What it computes, exactly as _ff_kernel does, per row of x:
//   [u | g] = x @ W1   (u the FIRST half, fp32 accumulation, not rounded)
//   a       = 0.5 * g * (1 + erf(g / sqrt(2))) * u   in fp32 (CUDA's erff;
//             the TPU kernel's polynomial exists only because Mosaic
//             has no erf)
//   out     = bf16(a) @ W2, fp32 accumulation, bf16 output.
// x: [n, 512] bf16; W1u, W1g: [512, inner_p] bf16 (the u and gate
// halves of W1, zero-padded from 1365 to inner_p, a multiple of 64);
// W2: [inner_p, 512] bf16 with zero rows past the true inner width;
// out: [n, 512] bf16.  The padding is made once when the weights are
// loaded; the zero columns give a = 0, which meets zero W2 rows, so the
// result is exact.
//
// Design.  The TPU kernel pins all of W1 and W2 (4.2 MB) in VMEM and
// tiles over rows; 227 KB of shared memory cannot hold them.  Here each
// block owns a 64-row tile of x (kept in shared memory) and streams the
// weights through 64-wide inner chunks from L2 (all three matrices fit
// in the 50 MB L2 many times over): per chunk it computes the u and
// gate chunks [64, 64] on the tensor cores, gates them into a bf16
// [64, 64] tile in shared memory, and adds that tile times the chunk's
// 64 rows of W2 into the fp32 [64, 512] output accumulator.  The W1
// halves of a chunk arrive in 128-row slices, copied 16 bytes at a time
// (cp.async) into a double-buffered stage while the previous slice is
// multiplied; fragment loads straight from global memory made this
// product three quarters of the kernel's time.  The
// accumulator stays in registers: 16 warps each own 32 output columns
// (8 WMMA accumulator fragments, 64 registers a thread), so the output
// columns are not split over blocks and the gate is never recomputed.
// The [n, 2 * inner] activation never reaches device memory.
//
// Bound on this card: 6 * n * 512 * 1365 = 85.6 GFLOP per layer at
// n = 20384 (about 87 us at 989 TFLOP/s bf16) against 42 MB of x and
// out (about 12 us at 3.35 TB/s): bound by operations.  This kernel
// feeds the tensor cores through WMMA (mma.sync class), so it runs
// well below that bound; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kD = 512;                 // model dim: x columns and out columns
constexpr int kBM = 64;                 // rows of x per block
constexpr int kBI = 64;                 // inner columns per chunk
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kOutCols = kD / kWarps;   // output columns owned by a warp (32)
constexpr int kLdx = kD + 8;            // bf16 row stride of the x tile
constexpr int kLdf = kBI + 4;           // fp32 row stride of the u, g tiles
constexpr int kLda = kBI + 8;           // bf16 row stride of the gated tile
constexpr int kSlice = 128;             // rows of a W1 half per staged slice
constexpr int kSlices = kD / kSlice;    // slices per inner chunk
constexpr int kLdw = kBI + 8;           // bf16 row stride of a staged slice
constexpr float kInvSqrt2 = 0.70710678118654752f;

constexpr size_t kXBytes = size_t(kBM) * kLdx * sizeof(__nv_bfloat16);
constexpr size_t kHBytes = size_t(kBM) * kLdf * sizeof(float);
constexpr size_t kABytes = size_t(kBM) * kLda * sizeof(__nv_bfloat16);
constexpr size_t kStageBytes = size_t(kWarps) * 256 * sizeof(float);
constexpr size_t kWBytes = size_t(kSlice) * kLdw * sizeof(__nv_bfloat16);
// x tile, u and gate tiles, gated tile, epilogue stage, and two buffers
// of the (u, gate) weight slices
constexpr size_t kSmemBytes = kXBytes + 2 * kHBytes + kABytes + kStageBytes + 4 * kWBytes;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 16 bytes global -> shared without passing through registers
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// waits until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(kThreads)
geglu_ff_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1u,
                const __nv_bfloat16* __restrict__ w1g, const __nv_bfloat16* __restrict__ w2,
                __nv_bfloat16* __restrict__ out, int n, int inner_p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  float* us = reinterpret_cast<float*>(smem + kXBytes);
  float* gs = us + kBM * kLdf;
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(gs + kBM * kLdf);
  float* stage = reinterpret_cast<float*>(as + kBM * kLda);
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(stage + kWarps * 256);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * kBM;
  const int n_slices = inner_p / kBI * kSlices;

  // start copying weight slice `slice` (chunk slice / kSlices, rows
  // (slice % kSlices) * kSlice of both W1 halves) into buffer slice % 2
  auto issue = [&](int slice) {
    const int c0 = slice / kSlices * kBI, row0 = slice % kSlices * kSlice;
    __nv_bfloat16* dst = wbuf + (slice & 1) * 2 * kSlice * kLdw;
    for (int i = tid; i < 2 * kSlice * (kBI / 8); i += kThreads) {
      const int mat = i / (kSlice * (kBI / 8)), rem = i % (kSlice * (kBI / 8));
      const int r = rem / (kBI / 8), c = rem % (kBI / 8) * 8;
      cp_async16(dst + mat * kSlice * kLdw + r * kLdw + c,
                 (mat ? w1g : w1u) + size_t(row0 + r) * inner_p + c0 + c);
    }
    cp_async_commit();
  };
  issue(0);

  // the x tile, 16 bytes per thread and step; rows at or past n are zero
  for (int i = tid; i < kBM * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < n) val = *reinterpret_cast<const uint4*>(x + size_t(m0 + r) * kD + c);
    *reinterpret_cast<uint4*>(xs + r * kLdx + c) = val;
  }

  // first-product work split: warps 0-7 make the u chunk, 8-15 the gate
  // chunk; each owns one 16-column fragment over two 16-row fragments,
  // so every weight fragment it loads serves two products
  const int h_half = warp < 8 ? 0 : 1;
  float* hs = h_half ? gs : us;
  const int h_cf = (warp % 8) / 2;       // column fragment 0..3
  const int h_rf = (warp % 2) * 2;       // first of two row fragments
  const int o_c0 = warp * kOutCols;      // first output column of this warp

  FragC acc[4][2];
#pragma unroll
  for (int rf = 0; rf < 4; ++rf)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[rf][j], 0.f);
  __syncthreads();

  int ws = 0;  // weight slice being multiplied
  for (int c0 = 0; c0 < inner_p; c0 += kBI) {
    // 1. u or gate chunk [64, 64] = x_tile @ W1half[:, c0:c0+64]
    {
      FragC h[2];
      wmma::fill_fragment(h[0], 0.f);
      wmma::fill_fragment(h[1], 0.f);
      for (int sl = 0; sl < kSlices; ++sl, ++ws) {
        if (ws + 1 < n_slices) {
          issue(ws + 1);
          cp_async_wait<1>();  // slice ws has landed, ws + 1 may fly
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();  // every thread's copies of slice ws are visible
        const __nv_bfloat16* wb = wbuf + ((ws & 1) * 2 + h_half) * kSlice * kLdw;
#pragma unroll
        for (int kk = 0; kk < kSlice / 16; ++kk) {
          FragB b;
          wmma::load_matrix_sync(b, wb + kk * 16 * kLdw + h_cf * 16, kLdw);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            FragA a;
            wmma::load_matrix_sync(a, xs + (h_rf + j) * 16 * kLdx + sl * kSlice + kk * 16, kLdx);
            wmma::mma_sync(h[j], a, b, h[j]);
          }
        }
        __syncthreads();  // every warp is done with buffer ws % 2 before refill
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(hs + (h_rf + j) * 16 * kLdf + h_cf * 16, h[j], kLdf,
                                wmma::mem_row_major);
    }
    __syncthreads();

    // 2. exact-erf GELU gate in fp32, rounded to bf16 for the second product
    for (int i = tid; i < kBM * kBI; i += kThreads) {
      const int r = i / kBI, c = i % kBI;
      const float g = gs[r * kLdf + c], u = us[r * kLdf + c];
      as[r * kLda + c] = __float2bfloat16(0.5f * g * (1.f + erff(g * kInvSqrt2)) * u);
    }
    __syncthreads();

    // 3. acc[:, o_c0:o_c0+32] += a @ W2[c0:c0+64, o_c0:o_c0+32]
#pragma unroll
    for (int kk = 0; kk < kBI / 16; ++kk) {
      FragB b[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], w2 + size_t(c0 + kk * 16) * kD + o_c0 + j * 16, kD);
#pragma unroll
      for (int rf = 0; rf < 4; ++rf) {
        FragA a;
        wmma::load_matrix_sync(a, as + rf * 16 * kLda + kk * 16, kLda);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[rf][j], a, b[j], acc[rf][j]);
      }
    }
    // no barrier needed here: the next chunk's step 1 writes only the
    // u / gate tiles, which step 2 finished reading before the barrier
    // above, and its own barrier orders these reads of `as` before
    // step 2 rewrites it
  }

  // epilogue: each fragment through a per-warp fp32 stage, then bf16 rows
  float* st = stage + warp * 256;
#pragma unroll
  for (int rf = 0; rf < 4; ++rf) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(st, acc[rf][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = m0 + rf * 16 + e / 16;
        if (row < n) out[size_t(row) * kD + o_c0 + j * 16 + e % 16] = __float2bfloat16(st[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [n, 512] bf16; w1u, w1g: [512, inner_p] bf16; w2: [inner_p, 512]
// bf16; inner_p a multiple of 64.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int mca_geglu_ff(const void* x, const void* w1u, const void* w1g, const void* w2,
                            void* out, int n, int inner_p, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      geglu_ff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const int blocks = (n + kBM - 1) / kBM;
  geglu_ff_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w1u),
      static_cast<const __nv_bfloat16*>(w1g), static_cast<const __nv_bfloat16*>(w2),
      static_cast<__nv_bfloat16*>(out), n, inner_p);
  return int(cudaGetLastError());
}
