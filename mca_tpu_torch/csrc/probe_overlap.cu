// Overlap probe (K7) for Hopper (sm_90a): can the tensor cores and the
// MUFU work at once inside one instruction stream?
//
// Replaces the TPU kernel baselines/probe_overlap.py::make_run's `kern`
// (launched through pl.pallas_call there), which asked the same of the
// TPU's matrix unit and its vector / transcendental unit.  Two chains
// that share no data:
//
//   mxu: a <- bf16(0.999 (a W)), a [128 x 256] bf16 a block, 16 rows a
//        warp as A fragments in registers, W [256 x 256] bf16 in shared
//        memory (mma_chain.cuh; the TPU chain is [256 x 256] x [256 x
//        256]): 512 HMMA.16816.F32.BF16 per warp and iteration;
//   vpu: b <- exp(-|b|) + 1e-3 on 32 fp32 registers a thread (the TPU's
//        [256 x 1024] tile split across the block's threads, [32 x 256]
//        a block), as 2^(-|b| log2 e): one MUFU.EX2 an element and step.
//        The chain takes one step over its 32 registers after every
//        fourth of the matrix chain's 64 k-steps, so one iteration is 16
//        exp steps an element (512 MUFU.EX2 a thread), which takes about
//        as long as the matrix chain's iteration: the arms are balanced,
//        where the probe separates overlap from the sum best.  16 steps
//        keep the chain off its fixed point (it contracts by about 0.57 a
//        step), so one iteration's output still shows its step count;
//   both: the two in one body, the exp steps between the products (after
//        every fourth k-step), so the HMMA and the MUFU.EX2 instructions
//        come from the same warp.
//
// The mode is a template parameter: the mxu kernel has no exp
// instruction and the vpu kernel no HMMA (tools/sass_counts.py, from
// cuobjdump -sass of the built library: the mxu loop holds 512 HMMA, the
// both loop 512 HMMA and 512 MUFU.EX2, its 16 exp steps unrolled between
// the k-steps; the vpu kernel's loop one step's 32 MUFU.EX2, run 16 times
// an iteration).  Both chains end in the stores of a and b, so no part
// of either is dead.  If the card runs the two units at once, `both`
// takes about max(mxu, vpu) per iteration; if it issues them one after
// the other, about mxu + vpu.  The blocks fill every SM once (one block
// of 8 warps an SM: W takes 135 KB).
//
// Bound: the tensor cores for mxu, the MUFU (16 operations a clock per
// SM) for vpu; nothing touches device memory inside the loop.

#include "mma_chain.cuh"

namespace {

enum Mode { kMxu = 0, kVpu = 1, kBoth = 2 };

constexpr int kExpPerThread = 32;
constexpr int kExpTile = kChainThreads * kExpPerThread;  // 8192 fp32 a block
constexpr int kExpCalls = kChainW / 16 / 4 * (kChainW / 64);  // 16: after every fourth k-step

template <bool kDoMxu, bool kDoExp>
__global__ void __launch_bounds__(kChainThreads, 1)
probe_overlap_kernel(const __nv_bfloat16* __restrict__ a0, const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ b0, __nv_bfloat16* __restrict__ a_out,
                     float* __restrict__ b_out, int iters) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = warp * 16;
  const size_t blk = blockIdx.x;

  if (kDoMxu) load_w_transposed(wt, w);
  uint32_t a[kChainW / 16][4];
  load_a256(a, a0 + blk * kChainRows * kChainW, r0, g, c2);
  float b[kExpPerThread];
#pragma unroll
  for (int j = 0; j < kExpPerThread; ++j) b[j] = b0[blk * kExpTile + j * kChainThreads + threadIdx.x];
  __syncthreads();

  // one exp step over the 32 registers; 16 call sites of 32 MUFU.EX2
  // each keep the combined body within the instruction cache (a version
  // that unrolled a longer exp loop at every k-step ran the combined body
  // at 1.7x the sum of the two alone)
  auto exp_step = [&]() {
    if (kDoExp) {
#pragma unroll
      for (int j = 0; j < kExpPerThread; ++j) b[j] = ex2_approx(fabsf(b[j]) * -kLog2e) + 1e-3f;
    }
  };
  for (int it = 0; it < iters; ++it) {
    if (kDoMxu) {
      chain_step(a, wt, g, c2, DecayEpi{}, exp_step);
    } else {
#pragma unroll 1
      for (int s = 0; s < kExpCalls; ++s) exp_step();
    }
  }

  store_a256(a_out + blk * kChainRows * kChainW, a, r0, g, c2);
#pragma unroll
  for (int j = 0; j < kExpPerThread; ++j) b_out[blk * kExpTile + j * kChainThreads + threadIdx.x] = b[j];
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
  return int(resident_blocks(kernel_of(kBoth), kChainThreads, kWBytes, blocks));
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
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kWBytes));
  if (err != cudaSuccess) return int(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* ah = static_cast<const __nv_bfloat16*>(a0);
  const auto* wh = static_cast<const __nv_bfloat16*>(w);
  const auto* bh = static_cast<const float*>(b0);
  auto* ao = static_cast<__nv_bfloat16*>(a_out);
  auto* bo = static_cast<float*>(b_out);
  if (mode == kMxu) {
    probe_overlap_kernel<true, false><<<n_blocks, kChainThreads, kWBytes, st>>>(
        ah, wh, bh, ao, bo, iters);
  } else if (mode == kVpu) {
    probe_overlap_kernel<false, true><<<n_blocks, kChainThreads, kWBytes, st>>>(
        ah, wh, bh, ao, bo, iters);
  } else {
    probe_overlap_kernel<true, true><<<n_blocks, kChainThreads, kWBytes, st>>>(
        ah, wh, bh, ao, bo, iters);
  }
  return int(cudaGetLastError());
}
