// Fused GEGLU feed-forward, forward, for Hopper (sm_90a): TMA, wgmma,
// warp specialisation, one persistent block per SM.
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
// x: [n, 512] bf16; w1t: [2 * inner_p, 512] bf16, W1 transposed with its
// u and gate columns interleaved in runs of 32 (every 64-wide inner chunk
// c is rows 128c.. : u 32 | g 32 | u 32 | g 32); w2t: [512, inner_p]
// bf16, W2 transposed; out: [n, 512] bf16 (ops/fused_ff.py
// prepare_geglu_weights makes the layout once, zero-padding the inner
// width from 1365 to inner_p = 1408; zero columns give a = 0, which
// meets zero W2 columns, so the result is exact).
//
// Design.  The TPU kernel pins all of W1 and W2 in VMEM and tiles over
// rows; 227 KB of shared memory cannot hold them, so the weights (4.3 MB
// padded, resident in the 50 MB L2) stream through shared memory per
// 64-row tile of x.  One block per SM walks the tiles n / 64 (319 at
// n = 20384: 2.42 waves over 132 SMs, so the last wave runs 55 of 132
// SMs and the kernel pays up to a 3 / 2.42 tail).  Each block has three
// warpgroups:
//   - the producer (one thread issues every copy, as TMA boxes of
//     64 x 64 or 64 x 256 bf16 in the 128-byte swizzle wgmma reads):
//     the x tile, resident for the tile; per 64-wide inner chunk the 8
//     K-slices of its 128 W1 rows through a 4-stage mbarrier ring, then
//     its W2 chunk [512 x 64];
//   - two consumer warpgroups, each owning 256 of the 512 output columns
//     (a 64 x 512 fp32 accumulator would take 256 registers a thread in
//     one warpgroup; 64 x 256 takes 128).  Per chunk each computes u and
//     the gate of its 32 inner columns as one wgmma m64n64k16 product
//     (A = the x tile, B = its 64 interleaved W1 rows), gates them in
//     registers (a thread holds u and g of the same entries), writes
//     bf16 into its half of a shared [64 x 64] gated tile (double
//     buffered), meets the other warpgroup at a named barrier, and
//     issues the second product, wgmma m64n256k16 over the chunk (A =
//     the gated tile, B = its 256 rows of the W2 chunk), without waiting
//     for it: it completes under the next chunk's first product, and the
//     W2 buffer is released then.
// The [n, 2 * inner] activation never reaches device memory, as in the
// TPU kernel.  Registers: setmaxnreg gives the producer 40 and each
// consumer 232 (128 + 32 accumulators).
//
// Shared memory (one block per SM): x tile 64 KB + W1 ring 4 x 16 KB +
// W2 chunk 64 KB + gated tile 2 x 8 KB = 208 KB, + 96 bytes of
// mbarriers + 1 KB of alignment slack, within 227 KB.  L2 traffic: every
// row tile re-reads the padded weights, 4.33 MB x 319 = 1.38 GB a call.
//
// Bound on this card: 6 * n * 512 * 1365 = 85.5 GFLOP per layer at
// n = 20384 (86 us at 989 TFLOP/s bf16) against 42 MB of x and out
// (13 us at 3.35 TB/s): bound by operations.
//
// Measured (chip_smoke.py phase 3, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.2281 ms at n = 20384 (375 TFLOP/s, 2.6x its bound; the mma.sync
// version before it took 0.98 ms); matmul -> gelu -> matmul in
// PyTorch takes 0.7266 ms on the unpadded W1 (rows of 5460 bytes) and
// 0.2497 ms on the padded halves.  Between it and the bound: the tail
// wave (3 / 2.42), the gating between the two products (the tensor
// cores wait for it: both warpgroups meet at the named barrier), and one
// W2 buffer.  SASS (tools/sass_counts.py): 8 HGMMA, 18 UTMALDG, no
// HMMA; ptxas: 168 registers at launch, no spills.

#include "hopper_common.cuh"

namespace {

constexpr int kD = 512;         // model dim: x columns and out columns
constexpr int kBM = 64;         // rows of x per tile
constexpr int kBK = 64;         // K (model dim) per TMA box and W1 stage
constexpr int kSlices = kD / kBK;
constexpr int kBI = 64;         // inner columns per chunk
constexpr int kStages = 4;      // W1 ring depth
constexpr int kThreads = 384;   // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr float kInvSqrt2 = 0.70710678118654752f;

constexpr uint32_t kBox = kBM * kBK * 2;              // one 64 x 64 box, 8 KB
constexpr uint32_t kXBytes = kSlices * kBox;          // 64 KB
constexpr uint32_t kW1Stage = 2 * kBox;               // 128 W1 rows x 64 K, 16 KB
constexpr uint32_t kW2Bytes = kD * kBI * 2;           // 64 KB
constexpr uint32_t kXOff = 0;
constexpr uint32_t kW1Off = kXOff + kXBytes;
constexpr uint32_t kW2Off = kW1Off + kStages * kW1Stage;
constexpr uint32_t kAOff = kW2Off + kW2Bytes;
constexpr uint32_t kBarOff = kAOff + 2 * kBox;
constexpr uint32_t kSmemBytes = kBarOff + (4 + 2 * kStages) * 8 + 1024;

__device__ __forceinline__ float gate(float u, float g) {
  return 0.5f * g * (1.f + erff(g * kInvSqrt2)) * u;
}

__global__ void __launch_bounds__(kThreads, 1)
geglu_ff_kernel(const __grid_constant__ CUtensorMap map_x,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2, __nv_bfloat16* __restrict__ out,
                int n, int n_chunks) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs = smem + kXOff;
  unsigned char* w1s = smem + kW1Off;
  unsigned char* w2s = smem + kW2Off;
  unsigned char* as = smem + kAOff;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* x_full = bars;
  uint64_t* x_empty = bars + 1;
  uint64_t* w2_full = bars + 2;
  uint64_t* w2_empty = bars + 3;
  uint64_t* w1_full = bars + 4;
  uint64_t* w1_empty = bars + 4 + kStages;

  const int n_tiles = (n + kBM - 1) / kBM;
  if (threadIdx.x == 0) {
    // full barriers: the producer's one arrival plus the bytes; empty
    // barriers: one arrival per consumer warp
    mbar_init(x_full, 1);
    mbar_init(x_empty, kConsumerWarps);
    mbar_init(w2_full, 1);
    mbar_init(w2_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w1_full + s, 1);
      mbar_init(w1_empty + s, kConsumerWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&map_x);
      prefetch_map(&map_w1);
      prefetch_map(&map_w2);
      int w1_it = 0, w2_it = 0, tile_it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++tile_it) {
        mbar_wait(x_empty, (tile_it & 1) ^ 1);
        mbar_expect_tx(x_full, kXBytes);
        for (int s = 0; s < kSlices; ++s)
          tma_load_2d(xs + s * kBox, &map_x, x_full, s * kBK, tile * kBM);
        for (int c = 0; c < n_chunks; ++c) {
          for (int s = 0; s < kSlices; ++s, ++w1_it) {
            const int st = w1_it % kStages;
            mbar_wait(w1_empty + st, ((w1_it / kStages) & 1) ^ 1);
            mbar_expect_tx(w1_full + st, kW1Stage);
            tma_load_2d(w1s + st * kW1Stage, &map_w1, w1_full + st, s * kBK, c * 2 * kBI);
          }
          mbar_wait(w2_empty, (w2_it & 1) ^ 1);
          mbar_expect_tx(w2_full, kW2Bytes);
          tma_load_2d(w2s, &map_w2, w2_full, c * kBI, 0);
          tma_load_2d(w2s + kW2Bytes / 2, &map_w2, w2_full, c * kBI, kD / 2);
          ++w2_it;
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<232>();
    const int cw = wg - 1;                 // output columns [256 cw, 256 cw + 256)
    const int wl = (threadIdx.x / 32) % 4; // warp within the warpgroup: rows 16 wl..
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const uint32_t xs_a = smem_u32(xs), w1_a = smem_u32(w1s) + cw * kBox;
    const uint32_t w2_a = smem_u32(w2s) + cw * (kW2Bytes / 2), as_a = smem_u32(as);

    float acc[128];
    float ug[32];
    int w1_it = 0, w2_it = 0, tile_it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++tile_it) {
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      mbar_wait(x_full, tile_it & 1);
      for (int c = 0; c < n_chunks; ++c) {
        // 1. [u | g] of this warpgroup's 32 inner columns: 8 K-slices
        for (int s = 0; s < kSlices; ++s, ++w1_it) {
          const int st = w1_it % kStages;
          mbar_wait(w1_full + st, (w1_it / kStages) & 1);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBK / 16; ++kk)
            wgmma_m64n64k16_ss(ug, wgmma_desc(xs_a + s * kBox + kk * 32),
                               wgmma_desc(w1_a + st * kW1Stage + kk * 32), (s | kk) != 0);
          wgmma_commit();
          wgmma_wait<1>();  // everything but this slice's products is done
          if (lane == 0) {
            if (s > 0)
              mbar_arrive(w1_empty + (w1_it - 1) % kStages);
            else if (c > 0)
              mbar_arrive(w2_empty);  // the previous chunk's second product
          }
        }
        wgmma_wait<0>();
        fence_regs(ug);
        if (lane == 0) {
          mbar_arrive(w1_empty + (w1_it - 1) % kStages);
          if (c == n_chunks - 1) mbar_arrive(x_empty);
        }

        // 2. gate in fp32, bf16 into this warpgroup's half of the gated tile
        const uint32_t a_tile = as_a + (w2_it & 1) * kBox;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 4 * j + 2 * h;
            const uint32_t v = pack_bf16x2(gate(ug[e], ug[16 + e]), gate(ug[e + 1], ug[17 + e]));
            const uint32_t addr = a_tile + swz128(16 * wl + g + 8 * h, 32 * cw + 8 * j + c2);
            asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
          }
        }
        fence_async_smem();
        named_barrier(1, 256);  // both halves of the gated tile are written

        // 3. acc += gated tile @ this warpgroup's 256 rows of the W2 chunk
        mbar_wait(w2_full, w2_it & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBI / 16; ++kk)
          wgmma_m64n256k16_ss(acc, wgmma_desc(a_tile + kk * 32), wgmma_desc(w2_a + kk * 32), 1);
        wgmma_commit();
        ++w2_it;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(w2_empty);

      // epilogue: bf16 pairs straight from the accumulator layout
      const int row0 = tile * kBM + 16 * wl + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= n) continue;
        __nv_bfloat16* orow = out + size_t(row) * kD + 256 * cw + c2;
#pragma unroll
        for (int j = 0; j < 32; ++j)
          *reinterpret_cast<uint32_t*>(orow + 8 * j) =
              pack_bf16x2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x, out: [n, 512] bf16; w1t: [2 * inner_p, 512] bf16 (interleaved);
// w2t: [512, inner_p] bf16; inner_p a multiple of 64.  Encodes the
// three tensor maps, launches one block per SM (at most one per tile)
// on `stream`, does not synchronise, returns cudaGetLastError() (or
// cudaErrorInvalidValue when cuTensorMapEncodeTiled refuses a map).
extern "C" int mca_geglu_ff(const void* x, const void* w1t, const void* w2t, void* out, int n,
                            int inner_p, void* stream) {
  CUtensorMap map_x, map_w1, map_w2;
  const uint64_t x_dims[2] = {uint64_t(kD), uint64_t(n)}, x_strides[1] = {kD * 2};
  const uint64_t w1_dims[2] = {uint64_t(kD), uint64_t(2 * inner_p)};
  const uint64_t w2_dims[2] = {uint64_t(inner_p), uint64_t(kD)};
  const uint64_t w2_strides[1] = {uint64_t(inner_p) * 2};
  const uint32_t x_box[2] = {kBK, kBM}, w1_box[2] = {kBK, 2 * kBI}, w2_box[2] = {kBI, kD / 2};
  if (!make_map(&map_x, x, 2, x_dims, x_strides, x_box) ||
      !make_map(&map_w1, w1t, 2, w1_dims, x_strides, w1_box) ||
      !make_map(&map_w2, w2t, 2, w2_dims, w2_strides, w2_box))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      geglu_ff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (n + kBM - 1) / kBM;
  const int blocks = n_tiles < sms ? n_tiles : sms;
  geglu_ff_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w1, map_w2, static_cast<__nv_bfloat16*>(out), n, inner_p / kBI);
  return int(cudaGetLastError());
}
