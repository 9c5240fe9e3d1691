// Overlap probe (K7) for Hopper (sm_90a): does the MUFU work while a
// warpgroup's own wgmma products are in flight?
//
// Replaces the TPU kernel baselines/probe_overlap.py::make_run's `kern`
// (launched through pl.pallas_call there), which asked the same of the
// TPU's matrix unit and its vector / transcendental unit.  Two chains
// that share no data, per iteration:
//
//   mxu:  a <- bf16(0.999 (a W)), a [128 x 256] bf16 a block, W [256 x
//         256] bf16 (the TPU chain is [256 x 256] x [256 x 256]);
//   vpu:  kExpCalls steps of b <- exp(-|b|) + 1e-3 on 32 fp32 registers a
//         thread (the TPU's [256 x 1024] tile split across the block's
//         threads, [32 x 256] a block), as 2^(-|b| log2 e): an FMUL, a
//         MUFU.EX2 and an FADD an element and step;
//   both: the two in one body.
//
// Dataflow, K6's big body (roofline_counter.cu), the one the flash
// kernels' products come from: one block an SM, two warpgroups of 64
// rows of a.  W is stored once as W^T, K-major in four 64-deep K slices,
// and each warpgroup's rows of a likewise, all in the 128-byte swizzle
// the wgmma descriptors read (hopper_common.cuh).  An iteration of a
// warpgroup issues 16 wgmma m64n256k16 from shared memory into 128 fp32
// accumulators a thread, commits them as one group, waits, and runs the
// epilogue: 0.999 x, round to bf16, rewrite its rows of a in place, fence
// the async proxy, meet at the warpgroup's named barrier.
//
// Where the exp steps sit in `both`: one step (32 MUFU.EX2 a thread)
// after each of the first kExpCalls products, before the commit and the
// wait.  So the MUFU.EX2 and the HGMMA come from the same warps, and the
// MUFU works while that warpgroup's own products are in flight.  If the
// card runs the two at once, `both` takes about max(mxu, vpu) per
// iteration; if not, about mxu + vpu.  The steps sit between the issues
// because a warp does not get far ahead of its products: with all nine
// steps in one loop after the sixteenth issue (the first design), `both`
// took the sum of the arms, 5.07-5.20 us an iteration (overlap fraction
// -0.04 to 0.01); four commit groups with the steps between them 3.97-4.00
// (0.48-0.49); a step after every second product 3.58-3.67 (0.54-0.64);
// warpgroup 1 running its steps before its issue, ping-pong, 4.66-4.68
// (0.19-0.21); a step after each product 3.39-3.44 (0.61-0.67), with or
// without a commit after each (tools/probe_overlap.py's per-iteration
// times, in pairs in one call each, NVIDIA H100 80GB HBM3, 700.00 W).
// kExpCalls balances the arms (probes.EXP_CALLS holds the same number):
// the probe separates overlap from the sum best when they take about as
// long alone.
//
// All three modes launch alike (grid, 256 threads, dynamic shared
// memory), so they run at one occupancy.  The mode is a template
// parameter: the mxu kernel holds no MUFU.EX2 and the vpu kernel no
// HGMMA (tools/sass_counts.py; chip_smoke.py phase 1 checks both).  Both
// chains end in the stores of a and b, so no part of either is dead.
//
// The prologue is short beside an 8-iteration launch: W (read from L2 by
// every block) moves as 8 x 8 blocks, eight 16-byte loads in, a transpose
// in registers, eight 16-byte stores out; a moves as 16-byte rows.
//
// Bound: the tensor cores for mxu (16.8 MFLOP a block and iteration,
// 2.24 us at 989 TFLOP/s over 132 SMs), the MUFU for vpu and both (16
// operations a clock per SM, 0.26 us an exp step at 1980 MHz); nothing
// touches device memory inside the loop.  Measured per iteration (same
// card and tool): mxu 2.50-2.74 us (82-90% of the tensor cores' peak;
// the mma.sync chain before it took 5.49-5.57), vpu 2.20-2.47 (9 steps),
// both 3.39-3.44.  chip_smoke.py's 8-iteration launches, on the device
// alone: mxu 0.0331 ms (0.0652 on mma.sync), vpu 0.0256, both 0.0396;
// about 12 us of the mxu launch is the launch, the prologue and the
// store of a.  ptxas: mxu 192 registers, vpu 123, both 220; no spills,
// no wgmma serialisation.

#include "flash_tile.cuh"  // kLog2e
#include "hopper_common.cuh"

namespace {

enum Mode { kMxu = 0, kVpu = 1, kBoth = 2 };

constexpr int kWarpgroup = 128;
constexpr int kThreads = 2 * kWarpgroup;
constexpr int kW = 256;                           // width and depth of the product
constexpr int kRows = 128;                        // rows of a a block: two warpgroups of 64
constexpr uint32_t kWSlice = kW * 64 * 2;         // W^T: 256 rows of one 64-deep K slice, 32 KB
constexpr uint32_t kASlice = 64 * 64 * 2;         // a: one warpgroup's 64 rows of a K slice, 8 KB
constexpr size_t kSmem = 4 * kWSlice + 2 * 4 * kASlice + 1024;  // W^T, a, alignment slack
constexpr int kExpPerThread = 32;
constexpr int kExpTile = kThreads * kExpPerThread;  // 8192 fp32 a block
constexpr int kExpCalls = 9;                         // exp steps an iteration
static_assert(kExpCalls <= kW / 16, "one exp step after each of the first kExpCalls products");

// word w (constant after unrolling) of a 16-byte value
__device__ __forceinline__ uint32_t word(const uint4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}

// W [256 x 256] (row-major: k, n) into shared memory as W^T, K slice k /
// 64, row n.  A thread moves 8 x 8 blocks: rows k0..k0 + 7 of W at
// columns n0..n0 + 7 in (eight 16-byte loads), transposed in registers
// (the bf16 of row k0 + j, column n0 + i goes to half j % 2 of word j / 2
// of output i), rows n0..n0 + 7 of W^T at k0..k0 + 7 out (eight 16-byte
// stores).  The eight lanes of a quarter-warp take eight k0 of one n0, so
// their stores fill one 128-byte row: no bank conflicts.
__device__ __forceinline__ void load_w_transposed(unsigned char* wt, const __nv_bfloat16* w) {
  for (int u = threadIdx.x; u < (kW / 8) * (kW / 8); u += blockDim.x) {
    const int kb = (u >> 8) * 8 + (u & 7), n0 = 8 * ((u >> 3) & 31);
    uint4 in[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      in[j] = *reinterpret_cast<const uint4*>(w + size_t(8 * kb + j) * kW + n0);
    unsigned char* dst = wt + (kb / 8) * kWSlice;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t sel = (i & 1) ? 0x7632u : 0x5410u;  // high or low halves of two words
      uint4 out;
      out.x = __byte_perm(word(in[0], i / 2), word(in[1], i / 2), sel);
      out.y = __byte_perm(word(in[2], i / 2), word(in[3], i / 2), sel);
      out.z = __byte_perm(word(in[4], i / 2), word(in[5], i / 2), sel);
      out.w = __byte_perm(word(in[6], i / 2), word(in[7], i / 2), sel);
      *reinterpret_cast<uint4*>(dst + swz128(n0 + i, 8 * (kb % 8))) = out;
    }
  }
}

template <bool kDoMxu, bool kDoExp>
__global__ void __launch_bounds__(kThreads, 1)
probe_overlap_kernel(const __nv_bfloat16* __restrict__ a0, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ b0, __nv_bfloat16* __restrict__ a_out,
                     float* __restrict__ b_out, int iters) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int wl = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * wl + g;
  unsigned char* a_tile = smem + 4 * kWSlice + wg * 4 * kASlice;  // this warpgroup's rows
  const size_t blk = blockIdx.x;

  if (kDoMxu) load_w_transposed(smem, w);
  const __nv_bfloat16* src = a0 + (blk * kRows + wg * 64) * kW;
#pragma unroll
  for (int sl = 0; sl < 4; ++sl)
    load_swizzled(a_tile + sl * kASlice, src, kW, 64 * sl, tid, kWarpgroup);
  float b[kExpPerThread];
#pragma unroll
  for (int j = 0; j < kExpPerThread; ++j) b[j] = b0[blk * kExpTile + j * kThreads + threadIdx.x];
  fence_async_smem();
  __syncthreads();
  const uint32_t w_a = smem_u32(smem), a_a = smem_u32(a_tile);

  float acc[128];
  for (int it = 0; it < iters; ++it) {
    // one exp step after each of the first kExpCalls products
    if (kDoMxu) wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kW / 16; ++kk) {
      if (kDoMxu)
        wgmma_m64n256k16_ss(acc, wgmma_desc(a_a + (kk / 4) * kASlice + 32 * (kk % 4)),
                            wgmma_desc(w_a + (kk / 4) * kWSlice + 32 * (kk % 4)), kk != 0);
      if (kDoExp && kk < kExpCalls) {
#pragma unroll
        for (int j = 0; j < kExpPerThread; ++j) b[j] = ex2_approx(fabsf(b[j]) * -kLog2e) + 1e-3f;
      }
    }
    if (kDoMxu) {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // a <- bf16(0.999 (a W)) on this thread's entries: rows r0 and r0 +
      // 8, columns 8 nb + c2 and + 1 (K slice nb / 8)
#pragma unroll
      for (int nb = 0; nb < kW / 8; ++nb) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          st_shared_u32(a_a + (nb / 8) * kASlice + swz128(r0 + 8 * hh, 8 * (nb % 8) + c2),
                        pack_bf16x2(0.999f * acc[4 * nb + 2 * hh], 0.999f * acc[4 * nb + 2 * hh + 1]));
      }
      fence_async_smem();
      named_barrier(1 + wg, kWarpgroup);  // this warpgroup's rows are rewritten
    }
  }

  __nv_bfloat16* dst = a_out + (blk * kRows + wg * 64) * kW;
#pragma unroll
  for (int sl = 0; sl < 4; ++sl)
    store_swizzled(dst, a_tile + sl * kASlice, kW, 64 * sl, tid, kWarpgroup);
#pragma unroll
  for (int j = 0; j < kExpPerThread; ++j) b_out[blk * kExpTile + j * kThreads + threadIdx.x] = b[j];
}

const void* kernel_of(int mode) {
  switch (mode) {
    case kMxu: return reinterpret_cast<const void*>(probe_overlap_kernel<true, false>);
    case kVpu: return reinterpret_cast<const void*>(probe_overlap_kernel<false, true>);
    case kBoth: return reinterpret_cast<const void*>(probe_overlap_kernel<true, true>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// SMs x the blocks of the probe kernel that fit on one SM.
extern "C" int mca_probe_overlap_blocks(int* blocks) {
  return int(resident_blocks(kernel_of(kBoth), kThreads, kSmem, blocks));
}

// mode: 0 mxu, 1 vpu, 2 both.  a0, a_out: n_blocks tiles of [128 x 256]
// bf16; w: [256 x 256] bf16; b0, b_out: n_blocks tiles of 8192 fp32.
// Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int mca_probe_overlap(int mode, const void* a0, const void* w, const void* b0,
                                 void* a_out, void* b_out, int n_blocks, int iters,
                                 void* stream) {
  const void* kernel = kernel_of(mode);
  if (kernel == nullptr || n_blocks <= 0) return int(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmem));
  if (err != cudaSuccess) return int(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ah = static_cast<const __nv_bfloat16*>(a0);
  const auto* wh = static_cast<const __nv_bfloat16*>(w);
  const auto* bh = static_cast<const float*>(b0);
  auto* ao = static_cast<__nv_bfloat16*>(a_out);
  auto* bo = static_cast<float*>(b_out);
  if (mode == kMxu) {
    probe_overlap_kernel<true, false><<<n_blocks, kThreads, kSmem, st>>>(ah, wh, bh, ao, bo, iters);
  } else if (mode == kVpu) {
    probe_overlap_kernel<false, true><<<n_blocks, kThreads, kSmem, st>>>(ah, wh, bh, ao, bo, iters);
  } else {
    probe_overlap_kernel<true, true><<<n_blocks, kThreads, kSmem, st>>>(ah, wh, bh, ao, bo, iters);
  }
  return int(cudaGetLastError());
}
