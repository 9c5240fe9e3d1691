// The overlap probe's positive control (K8) for Hopper (sm_90a): a copy
// stream against the matrix chain, where overlap is known to exist.
//
// Replaces the TPU kernel baselines/probe_overlap.py::make_ctl_run's
// `kern` (launched through pl.pallas_call there).  On the TPU, Mosaic's
// grid pipelining double-buffered each grid step's [512 x 1024] fp32
// block against the step's compute.  Here each block (one an SM, as
// many as reside at once) walks `steps` steps with an explicit double
// buffer in shared memory: step i of block b takes chunk
// b * p + i mod p of x, p = n_chunks / blocks, 44 KB ([11 x 1024]
// fp32); the two buffers and W fill 225,296 of the 232,448 bytes a
// block may use.
//
//   ctl_dma:  per step, wait for this step's chunk, issue the bulk copy
//             (TMA, cp.async.bulk with an mbarrier) of the next step's
//             chunk into the other buffer, scale the chunk in place
//             (y = x (1 + c)), and send it to y with a bulk store
//             (cp.async.bulk ... bulk_group): the device-memory bound;
//   ctl_mxu:  chunk 0 only, loaded once and scaled in place each step
//             (stored once, after the last step), plus `dots` chained
//             steps of mma_chain.cuh's a <- bf16(0.999 (a W)) (a [128 x
//             256] bf16 in registers, W in shared memory): pure compute;
//   ctl_both: ctl_dma's stream with ctl_mxu's dots after each step's
//             copies are issued.  If the copies run under the dots,
//             ctl_both takes about max(ctl_dma, ctl_mxu) per step.
//
// 512 HMMA per warp and dot (cuobjdump -sass).  The probe (K7) now
// issues wgmma; this control stays on mma.sync (mma_chain.cuh).
//
// Bound: per step a block moves 88 KB (44 KB in, 44 KB out), 11.9 MB
// for 132 blocks, 3.5 us at 3.35 TB/s; a dot is 16.8 MFLOP a block.

#include "mma_chain.cuh"  // and hopper_common.cuh: smem_u32, mbar_init, mbar_wait

namespace {

enum Mode { kDma = 0, kMxu = 1, kBoth = 2 };

constexpr int kChunk = 11 * 1024;  // fp32 values of one streamed chunk: 44 KB
constexpr uint32_t kChunkBytes = kChunk * sizeof(float);
constexpr size_t kCtlSmem = kWBytes + 2 * size_t(kChunkBytes) + 2 * sizeof(uint64_t);

// global -> shared, `bytes` (a multiple of 16), completing on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(kChunkBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(kChunkBytes), "r"(smem_u32(bar))
      : "memory");
}

// shared -> global in its own bulk group
__device__ __forceinline__ void bulk_store(float* dst, const float* src) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_u32(src)), "r"(kChunkBytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

template <bool kFresh, bool kDots>
__global__ void __launch_bounds__(kChainThreads, 1)
probe_ctl_kernel(const float* __restrict__ x, float* __restrict__ y, int n_chunks,
                 const __nv_bfloat16* __restrict__ a0, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ a_out, int steps, int dots, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);
  float* xb = reinterpret_cast<float*>(smem + kWBytes);  // two chunk buffers
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kWBytes + 2 * size_t(kChunkBytes));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = warp * 16;
  const size_t blk = blockIdx.x;
  // each block streams its own n_chunks / blocks chunks in turn, so a
  // chunk comes back only after the whole source has passed through L2
  // (blocks drift apart over a long launch: chunks shared between blocks
  // were read from L2 and the stream beat device memory)
  const size_t per_block = size_t(n_chunks) / gridDim.x;
  auto chunk = [&](int i) { return (blk * per_block + size_t(i) % per_block) * kChunk; };

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (kDots) load_w_transposed(wt, w);
  uint32_t a[kChainW / 16][4];
  load_a256(a, a0 + blk * kChainRows * kChainW, r0, g, c2);
  __syncthreads();
  if (tid == 0 && steps > 0) bulk_load(xb, x + chunk(0), &bar[0]);

  for (int i = 0; i < steps; ++i) {
    const int buf = kFresh ? (i & 1) : 0;
    float* cur = xb + buf * kChunk;
    if (kFresh || i == 0) mbar_wait(&bar[buf], kFresh ? (i >> 1) & 1 : 0);
    if (kFresh && tid == 0 && i + 1 < steps) {
      // step i - 1's store has finished reading the other buffer
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      bulk_load(xb + (buf ^ 1) * kChunk, x + chunk(i + 1), &bar[buf ^ 1]);
    }
    for (int e = tid * 4; e < kChunk; e += kChainThreads * 4) {
      float4 v = *reinterpret_cast<float4*>(cur + e);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
      *reinterpret_cast<float4*>(cur + e) = v;
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to the bulk store
    __syncthreads();
    if (kFresh && tid == 0) bulk_store(y + chunk(i), cur);
    if (kDots) {
      for (int d = 0; d < dots; ++d) chain_step(a, wt, g, c2, DecayEpi{});
    }
  }
  if (!kFresh && tid == 0 && steps > 0) bulk_store(y + chunk(0), xb);
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  store_a256(a_out + blk * kChainRows * kChainW, a, r0, g, c2);
}

const void* kernel_of(int mode) {
  switch (mode) {
    case kDma: return reinterpret_cast<const void*>(probe_ctl_kernel<true, false>);
    case kMxu: return reinterpret_cast<const void*>(probe_ctl_kernel<false, true>);
    case kBoth: return reinterpret_cast<const void*>(probe_ctl_kernel<true, true>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// SMs x the blocks of the control kernel that fit on one SM.
extern "C" int mca_probe_overlap_ctl_blocks(int* blocks) {
  return int(resident_blocks(kernel_of(kBoth), kChainThreads, kCtlSmem, blocks));
}

// mode: 0 ctl_dma, 1 ctl_mxu, 2 ctl_both.  x, y: [n_chunks, 11, 1024]
// fp32 (16-byte aligned), n_chunks >= n_blocks; a0, a_out: n_blocks tiles of [128 x 256] bf16;
// w: [256 x 256] bf16; scale = 1 + c.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int mca_probe_overlap_ctl(int mode, const void* x, void* y, int n_chunks,
                                     const void* a0, const void* w, void* a_out, int n_blocks,
                                     int steps, int dots, float scale, void* stream) {
  const void* kernel = kernel_of(mode);
  if (kernel == nullptr || n_blocks <= 0 || n_chunks < n_blocks) return int(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kCtlSmem));
  if (err != cudaSuccess) return int(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  auto* yf = static_cast<float*>(y);
  const auto* ah = static_cast<const __nv_bfloat16*>(a0);
  const auto* wh = static_cast<const __nv_bfloat16*>(w);
  auto* ao = static_cast<__nv_bfloat16*>(a_out);
  if (mode == kDma) {
    probe_ctl_kernel<true, false><<<n_blocks, kChainThreads, kCtlSmem, st>>>(
        xf, yf, n_chunks, ah, wh, ao, steps, dots, scale);
  } else if (mode == kMxu) {
    probe_ctl_kernel<false, true><<<n_blocks, kChainThreads, kCtlSmem, st>>>(
        xf, yf, n_chunks, ah, wh, ao, steps, dots, scale);
  } else {
    probe_ctl_kernel<true, true><<<n_blocks, kChainThreads, kCtlSmem, st>>>(
        xf, yf, n_chunks, ah, wh, ao, steps, dots, scale);
  }
  return int(cudaGetLastError());
}
