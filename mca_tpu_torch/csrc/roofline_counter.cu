// Roofline rate counter (K6) for Hopper (sm_90a): dependency-chained
// loops whose working set stays on chip, one per measured rate.
//
// Replaces the TPU kernel baselines/roofline.py::_counter_kernel (the
// `kern` body launched through pl.pallas_call there): a VMEM-resident
// fori_loop over one of five bodies.  Here one entry point,
// mca_roofline_counter(mode, ...), launches one of five kernels; each
// block reads its own tile of x0 once, runs `iters` iterations of the
// body on it with everything in registers and shared memory, and writes
// the tile to `out` once: nothing in the loop touches device memory.  A
// TPU core is one unit; this card has 132 SMs, so the wrapper launches as
// many blocks as the occupancy calculator lets reside at once
// (mca_roofline_counter_blocks) and every block chains its own copy.
//
// The three tensor-core bodies issue wgmma, the unit the flash kernels
// (K1, K2, K3a, K3b) and the fused FF (K5) use, with their dataflow.
// Operands in shared memory are 64-element bf16 rows in the 128-byte
// swizzle TMA writes (hopper_common.cuh), loaded once by plain stores.
// The bodies, with the TPU body each copies:
//
//   fwdpair (roofline.py:362-377), K1's tile dataflow: one warpgroup a
//     block holds a [64 x 64] bf16 q tile as wgmma register-A fragments;
//     k and v [64 x 64] bf16 in shared memory.  s = q k^T (wgmma
//     m64n64k16, k K-major), o = bf16(s) v (s as register A, v read
//     through the transpose bit), q <- bf16(q + eps o): 8 products a
//     warpgroup and iteration.
//   bwd5 (roofline.py:384-414), K2's tile dataflow as
//     flash_bwd_kv.cuh issues it: one warpgroup a block owns the 64 keys
//     of k and v; q (and do = q) in shared memory.  s^T = k q^T and
//     dp^T = v do^T (all operands K-major in shared memory), ds^T =
//     bf16(s^T + dp^T), dv = bf16(s^T) do and dk = ds^T q (register A,
//     do and q read MN-major), dq = ds k (ds^T through shared memory, both
//     operands MN-major), fold = column sums of dv + dk over the 64 keys,
//     q <- bf16(q + eps (dq + fold)) written back to shared memory: 20
//     products a warpgroup and iteration.  dv takes bf16(s) where the TPU
//     body reuses ds: with do = q, ds^T do and ds^T q are the same product
//     of the same operands, which the compiler may merge; K2's dv takes
//     p, which comes from s.
//   big (roofline.py:427-437), the deep-contraction reference: a 1024^2
//     operand does not fit in one SM, so a block chains a [128 x 256] x
//     [256 x 256] product, a <- bf16(a + scale (a W)), as K5 issues its
//     second product: two warpgroups of 64 rows, each 16 wgmma
//     m64n256k16 an iteration with its rows of a and W (stored W^T, K
//     in four 64-wide slices) both K-major in shared memory; a is
//     rewritten there in place.
//   vpu (roofline.py:446-452): x <- x - c x x on 16 fp32 registers a
//     thread (one FMUL and one FFMA each), [64 x 64] a block.
//   exp (roofline.py:458-464): x <- exp(-x - eps) on 16 fp32 registers a
//     thread, as 2^(-(x + eps) log2 e): one FFMA and one MUFU.EX2 each.
//
// Dead work.  Every product feeds the chain's next iteration and the
// final store, so the compiler can drop none of it; cuobjdump -sass of
// the built library (tools/sass_counts.py) shows, per iteration of each
// kernel's loop: fwdpair 8 HGMMA, bwd5 20, big 16 (these loops are not
// unrolled: the kernels hold exactly that many); exp 16 MUFU.EX2 a
// thread (80 in the kernel: the loop unrolled four times, and its
// remainder).
//
// Bound: none of the loops touches device memory, so each is bound by
// its unit: the tensor cores for fwdpair, bwd5 and big, the FP32 pipe for
// vpu and the MUFU (16 operations a clock per SM) for exp.  What they
// measure is how close the port's own wgmma dataflows can come to those
// units: the tools' yardstick for the kernels built from them.
//
// Measured (tools/roofline.py's rate pass, NVIDIA H100 80GB HBM3, 700.00
// W): fwdpair 763-778 TFLOP/s (660 blocks, 5 an SM), bwd5 426 (396, 3 an
// SM), big 795-796 (132); the mma.sync bodies before them read 392, 293
// and 387 in the same call.  ptxas: fwdpair 90 registers, bwd5 154, big
// 193; no spills, no wgmma serialisation.

#include "flash_tile.cuh"
#include "hopper_common.cuh"

namespace {

enum Mode { kFwdpair = 0, kBwd5 = 1, kBig = 2, kVpu = 3, kExp = 4 };

constexpr int kWarpgroup = 128;
constexpr int kSweepThreads = 256;
constexpr int kSweepPerThread = 16;
constexpr int kSweepTile = kSweepThreads * kSweepPerThread;  // 4096 fp32 a block
constexpr int kQTile = kBlock * kD;                            // 64 x 64 bf16 a block
constexpr uint32_t kTileBytes = kQTile * 2;                    // 8 KB

constexpr int kBigW = 256;                      // width and depth of big's product
constexpr int kBigRows = 128;                   // rows of a a block: two warpgroups of 64
constexpr uint32_t kWSlice = kBigW * 64 * 2;    // W^T: 256 rows of one 64-deep K slice, 32 KB
constexpr uint32_t kASlice = 64 * 64 * 2;       // a: one warpgroup's 64 rows of a K slice, 8 KB

// 1024 bytes of slack for aligning the dynamic shared memory
constexpr size_t kFwdpairSmem = 2 * kTileBytes + 1024;                 // k, v
constexpr size_t kBwd5Smem = 4 * kTileBytes + 4 * kD * 4 + 1024;      // k, v, q, ds^T, fold
constexpr size_t kBigSmem = 4 * kWSlice + 2 * 4 * kASlice + 1024;     // W^T, a

// bf16(x + eps * (o0, o1)) of a packed pair x, element by element
__device__ __forceinline__ uint32_t add_scaled(uint32_t x, float o0, float o1, float eps) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
  return pack_bf16x2(f.x + o0 * eps, f.y + o1 * eps);
}

// the accumulators of column blocks 2j and 2j + 1 (rows r0, r0 + 8) as
// the bf16 A fragment of the j-th 16-wide step
__device__ __forceinline__ void pack_a(uint32_t (&a)[kBlock / 16][4], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < kBlock / 16; ++j) {
    a[j][0] = pack_bf16x2(x[8 * j + 0], x[8 * j + 1]);
    a[j][1] = pack_bf16x2(x[8 * j + 2], x[8 * j + 3]);
    a[j][2] = pack_bf16x2(x[8 * j + 4], x[8 * j + 5]);
    a[j][3] = pack_bf16x2(x[8 * j + 6], x[8 * j + 7]);
  }
}

__global__ void __launch_bounds__(kWarpgroup)
fwdpair_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ kv,
               __nv_bfloat16* __restrict__ out, int iters, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int wl = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * wl + g;

  load_swizzled(smem, kv, kD, 0, threadIdx.x, kWarpgroup);                        // k
  load_swizzled(smem + kTileBytes, kv + kQTile, kD, 0, threadIdx.x, kWarpgroup);  // v
  fence_async_smem();
  const uint32_t k_a = smem_u32(smem), v_a = k_a + kTileBytes;
  const __nv_bfloat16* src = x0 + size_t(blockIdx.x) * kQTile;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qa[kk][e] = *reinterpret_cast<const uint32_t*>(
          src + (r0 + 8 * (e & 1)) * kD + 16 * kk + 8 * (e >> 1) + c2);
  }
  __syncthreads();

  float s[32], o[32];
  uint32_t pa[kBlock / 16][4];
  for (int it = 0; it < iters; ++it) {
    // s = q k^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_rs<0>(s, qa[kk], wgmma_desc(k_a + 32 * kk), kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    pack_a(pa, s);
    // o = bf16(s) v
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j)
      wgmma_m64n64k16_rs<1>(o, pa[j], wgmma_desc(v_a + 2048 * j), j != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    // o's column blocks 2kk and 2kk + 1 are q's k-step kk
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        qa[kk][e] = add_scaled(qa[kk][e], o[8 * kk + 2 * e], o[8 * kk + 2 * e + 1], eps);
    }
  }

  __nv_bfloat16* dst = out + size_t(blockIdx.x) * kQTile;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8 * (e & 1)) * kD + 16 * kk + 8 * (e >> 1) + c2) =
          qa[kk][e];
  }
}

__global__ void __launch_bounds__(kWarpgroup)
bwd5_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ kv,
            __nv_bfloat16* __restrict__ out, int iters, float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  unsigned char* q_tile = smem + 2 * kTileBytes;
  float* fold_s = reinterpret_cast<float*>(smem + 4 * kTileBytes);  // [warp][d]
  const int wl = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * wl + g;

  load_swizzled(smem, kv, kD, 0, threadIdx.x, kWarpgroup);                        // k
  load_swizzled(smem + kTileBytes, kv + kQTile, kD, 0, threadIdx.x, kWarpgroup);  // v
  load_swizzled(q_tile, x0 + size_t(blockIdx.x) * kQTile, kD, 0, threadIdx.x, kWarpgroup);
  fence_async_smem();
  __syncthreads();
  const uint32_t k_a = smem_u32(smem), v_a = k_a + kTileBytes;
  const uint32_t q_a = k_a + 2 * kTileBytes, ds_a = k_a + 3 * kTileBytes;

  float s[32], dp[32], dv[32], dk[32];
  uint32_t pa[kBlock / 16][4], dsa[kBlock / 16][4];
  for (int it = 0; it < iters; ++it) {
    // s^T = k q^T and dp^T = v do^T (do = q): rows = keys, columns = queries
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss(s, wgmma_desc(k_a + 32 * kk), wgmma_desc(q_a + 32 * kk), kk != 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_m64n64k16_ss(dp, wgmma_desc(v_a + 32 * kk), wgmma_desc(q_a + 32 * kk), kk != 0);
    wgmma_commit();

    // dv = bf16(s^T) do: do's 16 query rows of a step are an MN-major B
    wgmma_wait<1>();
    fence_regs(s);
    pack_a(pa, s);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j)
      wgmma_m64n64k16_rs<1>(dv, pa[j], wgmma_desc(q_a + 2048 * j), j != 0);
    wgmma_commit();

    // ds^T = bf16(s^T + dp^T) in place of dp^T, as register A and as
    // [key][query] rows in shared memory; dk = ds^T q
    wgmma_wait<1>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] += s[i];
    pack_a(dsa, dp);
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        st_shared_u32(ds_a + swz128(r0 + 8 * (e & 1), 16 * j + 8 * (e >> 1) + c2), dsa[j][e]);
    }
    fence_async_smem();
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j)
      wgmma_m64n64k16_rs<1>(dk, dsa[j], wgmma_desc(q_a + 2048 * j), j != 0);
    wgmma_commit();

    // dq = ds k: rows = queries; A = ds^T read MN-major, B = k read
    // MN-major, 16 keys a step (into s, which is consumed)
    __syncthreads();  // every warp's ds^T rows are stored
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kBlock / 16; ++j)
      wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(ds_a + 2048 * j), wgmma_desc(k_a + 2048 * j),
                               j != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(s);

    // fold: column sums of dv + dk over the 64 keys (rows r0 and r0 + 8
    // here, then across the quad's 8 row groups, then across the warps)
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float f = dv[4 * nb + e] + dk[4 * nb + e] + dv[4 * nb + 2 + e] + dk[4 * nb + 2 + e];
        f += __shfl_xor_sync(0xffffffffu, f, 4);
        f += __shfl_xor_sync(0xffffffffu, f, 8);
        f += __shfl_xor_sync(0xffffffffu, f, 16);
        if (g == 0) fold_s[wl * kD + 8 * nb + c2 + e] = f;
      }
    }
    __syncthreads();

    // q <- bf16(q + eps (dq + fold)), in place in shared memory
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      const int c = 8 * nb + c2;
      float fold[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)
        fold[e] = fold_s[c + e] + fold_s[kD + c + e] + fold_s[2 * kD + c + e] +
                  fold_s[3 * kD + c + e];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t addr = q_a + swz128(r0 + 8 * hh, c);
        st_shared_u32(addr, add_scaled(ld_shared_u32(addr), s[4 * nb + 2 * hh] + fold[0],
                                              s[4 * nb + 2 * hh + 1] + fold[1], eps));
      }
    }
    fence_async_smem();
    __syncthreads();
  }

  store_swizzled(out + size_t(blockIdx.x) * kQTile, q_tile, kD, 0, threadIdx.x, kWarpgroup);
}

__global__ void __launch_bounds__(2 * kWarpgroup, 1)
big_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ w,
           __nv_bfloat16* __restrict__ out, int iters, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int wg = threadIdx.x / kWarpgroup, tid = threadIdx.x % kWarpgroup;
  const int wl = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = 16 * wl + g;
  unsigned char* a_tile = smem + 4 * kWSlice + wg * 4 * kASlice;  // this warpgroup's rows

  // W [256 x 256] (row-major: k, n) as W^T: K slice k / 64, row n
  for (int i = threadIdx.x; i < kBigW * kBigW; i += blockDim.x) {
    const int k = i / kBigW, n = i % kBigW;
    *reinterpret_cast<__nv_bfloat16*>(smem + (k / 64) * kWSlice + swz128(n, k % 64)) = w[i];
  }
  const __nv_bfloat16* src = x0 + (size_t(blockIdx.x) * kBigRows + wg * 64) * kBigW;
#pragma unroll
  for (int sl = 0; sl < 4; ++sl)
    load_swizzled(a_tile + sl * kASlice, src, kBigW, 64 * sl, tid, kWarpgroup);
  fence_async_smem();
  __syncthreads();
  const uint32_t w_a = smem_u32(smem), a_a = smem_u32(a_tile);

  float acc[128];
  for (int it = 0; it < iters; ++it) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBigW / 16; ++kk)
      wgmma_m64n256k16_ss(acc, wgmma_desc(a_a + (kk / 4) * kASlice + 32 * (kk % 4)),
                          wgmma_desc(w_a + (kk / 4) * kWSlice + 32 * (kk % 4)), kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // a <- bf16(a + scale (a W)) on this thread's entries: rows r0 and
    // r0 + 8, columns 8 nb + c2 and + 1 (K slice nb / 8)
#pragma unroll
    for (int nb = 0; nb < kBigW / 8; ++nb) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t addr = a_a + (nb / 8) * kASlice + swz128(r0 + 8 * hh, 8 * (nb % 8) + c2);
        st_shared_u32(addr, add_scaled(ld_shared_u32(addr), acc[4 * nb + 2 * hh],
                                              acc[4 * nb + 2 * hh + 1], scale));
      }
    }
    fence_async_smem();
    named_barrier(1 + wg, kWarpgroup);  // this warpgroup's rows are rewritten
  }

  __nv_bfloat16* dst = out + (size_t(blockIdx.x) * kBigRows + wg * 64) * kBigW;
#pragma unroll
  for (int sl = 0; sl < 4; ++sl)
    store_swizzled(dst, a_tile + sl * kASlice, kBigW, 64 * sl, tid, kWarpgroup);
}

template <int kMode>
__global__ void __launch_bounds__(kSweepThreads)
sweep_kernel(const float* __restrict__ x0, float* __restrict__ out, int iters, float c) {
  const float* src = x0 + size_t(blockIdx.x) * kSweepTile;
  float x[kSweepPerThread];
#pragma unroll
  for (int j = 0; j < kSweepPerThread; ++j) x[j] = src[j * kSweepThreads + threadIdx.x];
  const float bias = -c * kLog2e;  // exp: 2^(-(x + c) log2 e)
#pragma unroll 4
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kSweepPerThread; ++j) {
      if (kMode == kVpu) {
        x[j] = x[j] - c * x[j] * x[j];
      } else {
        x[j] = ex2_approx(fmaf(x[j], -kLog2e, bias));
      }
    }
  }
  float* dst = out + size_t(blockIdx.x) * kSweepTile;
#pragma unroll
  for (int j = 0; j < kSweepPerThread; ++j) dst[j * kSweepThreads + threadIdx.x] = x[j];
}

struct Launch {
  const void* kernel;
  int threads;
  size_t smem;
};

Launch launch_of(int mode) {
  switch (mode) {
    case kFwdpair: return {reinterpret_cast<const void*>(fwdpair_kernel), kWarpgroup, kFwdpairSmem};
    case kBwd5: return {reinterpret_cast<const void*>(bwd5_kernel), kWarpgroup, kBwd5Smem};
    case kBig: return {reinterpret_cast<const void*>(big_kernel), 2 * kWarpgroup, kBigSmem};
    case kVpu: return {reinterpret_cast<const void*>(sweep_kernel<kVpu>), kSweepThreads, 0};
    case kExp: return {reinterpret_cast<const void*>(sweep_kernel<kExp>), kSweepThreads, 0};
    default: return {nullptr, 0, 0};
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The number of blocks of `mode`'s kernel that reside on the card at
// once: SMs x cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int mca_roofline_counter_blocks(int mode, int* blocks) {
  const Launch l = launch_of(mode);
  if (l.kernel == nullptr) return int(cudaErrorInvalidValue);
  return int(resident_blocks(l.kernel, l.threads, l.smem, blocks));
}

// mode: 0 fwdpair, 1 bwd5, 2 big, 3 vpu, 4 exp.  x0, out: n_blocks tiles
// of [64 x 64] bf16 (fwdpair, bwd5), [128 x 256] bf16 (big) or 4096 fp32
// (vpu, exp); aux: k and v stacked, [128 x 64] bf16 (fwdpair, bwd5), W
// [256 x 256] bf16 (big), unused otherwise.  eps: eps (fwdpair, bwd5,
// exp), scale (big) or c (vpu).  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int mca_roofline_counter(int mode, const void* x0, const void* aux, void* out,
                                    int n_blocks, int iters, float eps, void* stream) {
  const Launch l = launch_of(mode);
  if (l.kernel == nullptr || n_blocks <= 0) return int(cudaErrorInvalidValue);
  cudaError_t err =
      cudaFuncSetAttribute(l.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(l.smem));
  if (err != cudaSuccess) return int(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xh = static_cast<const __nv_bfloat16*>(x0);
  const __nv_bfloat16* ah = static_cast<const __nv_bfloat16*>(aux);
  __nv_bfloat16* oh = static_cast<__nv_bfloat16*>(out);
  switch (mode) {
    case kFwdpair:
      fwdpair_kernel<<<n_blocks, l.threads, l.smem, st>>>(xh, ah, oh, iters, eps);
      break;
    case kBwd5:
      bwd5_kernel<<<n_blocks, l.threads, l.smem, st>>>(xh, ah, oh, iters, eps);
      break;
    case kBig:
      big_kernel<<<n_blocks, l.threads, l.smem, st>>>(xh, ah, oh, iters, eps);
      break;
    case kVpu:
      sweep_kernel<kVpu><<<n_blocks, l.threads, 0, st>>>(static_cast<const float*>(x0),
                                                         static_cast<float*>(out), iters, eps);
      break;
    default:
      sweep_kernel<kExp><<<n_blocks, l.threads, 0, st>>>(static_cast<const float*>(x0),
                                                         static_cast<float*>(out), iters, eps);
      break;
  }
  return int(cudaGetLastError());
}
