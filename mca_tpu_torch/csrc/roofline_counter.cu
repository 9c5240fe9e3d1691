// Roofline rate counter (K6) for Hopper (sm_90a): dependency-chained
// loops whose working set stays on chip, one per measured rate.
//
// Replaces the TPU kernel baselines/roofline.py::_counter_kernel (the
// `kern` body launched through pl.pallas_call there): a VMEM-resident
// fori_loop over one of five bodies.  Here one entry point,
// mca_roofline_counter(mode, ...), launches one of five kernels; each
// block reads its own tile of x0, runs `iters` iterations of the body on
// it with everything in registers and shared memory, and writes the tile
// to `out` once.  A TPU core is one unit; this card has 132 SMs, so the
// wrapper launches as many blocks as the occupancy calculator lets reside
// at once (mca_roofline_counter_blocks) and every block chains its own
// copy.  The bodies, with the TPU body each copies:
//
//   fwdpair (roofline.py:362-377), K1's tile dataflow: per warp 16 rows
//     of a [64 x 64] bf16 q tile as A fragments; k (row-major) and v
//     (transposed) [64 x 64] bf16 in shared memory;
//     s = q k^T (fp32), o = bf16(s) v (fp32), q <- bf16(q + eps o).
//     64 m16n8k16 products per warp and iteration.
//   bwd5 (roofline.py:384-414), K2's tile dataflow: per warp 16 keys of
//     k and v as A fragments; q through shared memory row-major and
//     transposed; do = q.  s^T = k q^T, dp^T = v do^T, ds = bf16(s + dp),
//     dv = bf16(s)^T do, dk = ds^T q, dq = ds k (ds through shared memory,
//     k^T kept there), fold = column sums of dv + dk over the 64 keys,
//     q <- bf16(q + eps (dq + fold)).  160 products per warp and
//     iteration.  dv takes bf16(s) where the TPU body reuses ds: with
//     do = q, ds^T do and ds^T q are the same product of the same
//     registers, which the compiler may merge; K2's dv takes p, which
//     comes from s.
//   big (roofline.py:427-437), the deep-contraction reference: a 1024^2
//     operand does not fit in one SM, so a block chains mma_chain.cuh's
//     [128 x 256] x [256 x 256] product, a <- bf16(a + scale (a W)), W in
//     shared memory; 512 products per warp and iteration.
//   vpu (roofline.py:446-452): x <- x - c x x on 16 fp32 registers a
//     thread (one FMUL and one FFMA each), [64 x 64] a block.
//   exp (roofline.py:458-464): x <- exp(-x - eps) on 16 fp32 registers a
//     thread, as 2^(-(x + eps) log2 e): one FFMA and one MUFU.EX2 each.
//
// Dead work.  Every product feeds the chain's next iteration and the
// final store, so the compiler can drop none of it; cuobjdump -sass of
// the built library (tools/sass_counts.py) shows, per iteration of each
// kernel's loop (per warp):
//   fwdpair 64 HMMA.16816.F32.BF16, bwd5 160, big 512 (these loops are
//   not unrolled: the kernels hold exactly that many);
//   exp 16 MUFU.EX2 a thread (80 in the kernel: the loop unrolled four
//   times, and its remainder).
//
// Bound: none of the loops touches device memory, so each is bound by
// its unit: the tensor cores for fwdpair, bwd5 and big (mma.sync, not
// wgmma, as the flash kernels issue it), the FP32 pipe for vpu and the
// MUFU (16 operations a clock per SM) for exp.  What they measure is how
// close the port's own dataflow can come to those units.

#include "mma_chain.cuh"

namespace {

enum Mode { kFwdpair = 0, kBwd5 = 1, kBig = 2, kVpu = 3, kExp = 4 };

constexpr int kSweepThreads = 256;
constexpr int kSweepPerThread = 16;
constexpr int kSweepTile = kSweepThreads * kSweepPerThread;  // 4096 fp32 a block
constexpr int kQTile = kBlock * kD;                            // 64 x 64 bf16 a block

constexpr size_t kFwdpairSmem = 2 * kTileH;
constexpr size_t kBwd5Smem = 4 * kTileH + kWarps * kD * sizeof(float);

// q <- bf16(q + eps * o) on one packed pair
__device__ __forceinline__ uint32_t add_scaled(uint32_t q, float o0, float o1, float eps) {
  const float2 f = unpack_bf16(q);
  return pack_bf16(f.x + o0 * eps, f.y + o1 * eps);
}

__global__ void __launch_bounds__(kThreads)
fwdpair_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ kv,
               __nv_bfloat16* __restrict__ out, int iters, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // k: [key][d]
  __nv_bfloat16* vt = ks + kBlock * kLdh;                      // v^T: [d][key]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = warp * 16;

  load_tile(ks, kv, 0, kBlock, 1.f);
  load_tile_transposed(vt, kv + kBlock * kD, 0, kBlock);
  const __nv_bfloat16* src = x0 + size_t(blockIdx.x) * kQTile;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const __nv_bfloat16* p = src + (r0 + g) * kD + kk * 16 + c2;
    qa[kk][0] = ld32(p);
    qa[kk][1] = ld32(p + 8 * kD);
    qa[kk][2] = ld32(p + 8);
    qa[kk][3] = ld32(p + 8 * kD + 8);
  }
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float s[kBlock / 8][4], o[kD / 8][4];
    zero_acc(s);
    mma_a_bt(s, qa, ks, g, c2);  // s = q k^T
    zero_acc(o);
    mma_acc_b(o, s, vt, g, c2);  // o = bf16(s) v
    // o's column blocks 2kk and 2kk + 1 are q's k-step kk
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      qa[kk][0] = add_scaled(qa[kk][0], o[2 * kk][0], o[2 * kk][1], eps);
      qa[kk][1] = add_scaled(qa[kk][1], o[2 * kk][2], o[2 * kk][3], eps);
      qa[kk][2] = add_scaled(qa[kk][2], o[2 * kk + 1][0], o[2 * kk + 1][1], eps);
      qa[kk][3] = add_scaled(qa[kk][3], o[2 * kk + 1][2], o[2 * kk + 1][3], eps);
    }
  }

  __nv_bfloat16* dst = out + size_t(blockIdx.x) * kQTile;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    __nv_bfloat16* p = dst + (r0 + g) * kD + kk * 16 + c2;
    *reinterpret_cast<uint32_t*>(p) = qa[kk][0];
    *reinterpret_cast<uint32_t*>(p + 8 * kD) = qa[kk][1];
    *reinterpret_cast<uint32_t*>(p + 8) = qa[kk][2];
    *reinterpret_cast<uint32_t*>(p + 8 * kD + 8) = qa[kk][3];
  }
}

__global__ void __launch_bounds__(kThreads)
bwd5_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ kv,
            __nv_bfloat16* __restrict__ out, int iters, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // q: [q][d]
  __nv_bfloat16* qt = qs + kBlock * kLdh;                      // q^T: [d][q]
  __nv_bfloat16* kt = qt + kD * kLdh;                          // k^T: [d][key]
  __nv_bfloat16* dss = kt + kD * kLdh;                         // ds: [q][key]
  float* fold_s = reinterpret_cast<float*>(dss + kBlock * kLdh);  // [warp][d]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = warp * 16;

  // this warp's keys of k and v as A fragments, through qs / dss (free
  // until the loop starts); k^T stays for the dq product
  load_tile_transposed(kt, kv, 0, kBlock, 1.f, qs);
  load_tile(dss, kv + kBlock * kD, 0, kBlock, 1.f);
  __syncthreads();
  uint32_t ka[kD / 16][4], va[kD / 16][4];
  load_a_frags(ka, qs, r0, g, c2);
  load_a_frags(va, dss, r0, g, c2);
  __syncthreads();
  load_tile_transposed(qt, x0 + size_t(blockIdx.x) * kQTile, 0, kBlock, 1.f, qs);
  __syncthreads();
  // this warp's 16 q rows (r0 + g, r0 + g + 8) in the accumulator layout
  uint32_t qown[kD / 8][2];
#pragma unroll
  for (int nb = 0; nb < kD / 8; ++nb) {
    qown[nb][0] = ld32(qs + (r0 + g) * kLdh + nb * 8 + c2);
    qown[nb][1] = ld32(qs + (r0 + g + 8) * kLdh + nb * 8 + c2);
  }

  for (int it = 0; it < iters; ++it) {
    // s^T = k q^T and dp^T = v do^T (do = q): rows are this warp's keys
    float s[kBlock / 8][4], ds[kBlock / 8][4];
    zero_acc(s);
    mma_a_bt(s, ka, qs, g, c2);
    zero_acc(ds);
    mma_a_bt(ds, va, qs, g, c2);
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[nb][e] += s[nb][e];  // rounded to bf16 where used
    }
    // dv = bf16(s)^T do, dk = bf16(ds)^T q: [this warp's keys x d]
    float dv[kD / 8][4], dk[kD / 8][4];
    zero_acc(dv);
    mma_acc_b(dv, s, qt, g, c2);
    zero_acc(dk);
    mma_acc_b(dk, ds, qt, g, c2);
    // ds (bf16) to shared memory as [q][key] for the dq product
#pragma unroll
    for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = r0 + g + (e >> 1) * 8, c = nb * 8 + c2 + (e & 1);
        dss[c * kLdh + key] = __float2bfloat16_rn(ds[nb][e]);
      }
    }
    // fold: this warp's column sums of dv + dk (over its 16 keys: rows
    // g and g + 8 here, then across the 8 values of g)
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float f = dv[nb][h] + dk[nb][h] + dv[nb][h + 2] + dk[nb][h + 2];
        f += __shfl_xor_sync(0xffffffffu, f, 4);
        f += __shfl_xor_sync(0xffffffffu, f, 8);
        f += __shfl_xor_sync(0xffffffffu, f, 16);
        if (g == 0) fold_s[warp * kD + nb * 8 + c2 + h] = f;
      }
    }
    __syncthreads();

    // dq = ds k for this warp's 16 q rows
    uint32_t dsa[kBlock / 16][4];
    load_a_frags(dsa, dss, r0, g, c2);
    float dq[kD / 8][4];
    zero_acc(dq);
    mma_a_bt(dq, dsa, kt, g, c2);

    // q <- bf16(q + eps (dq + fold)), back to shared memory both ways
#pragma unroll
    for (int nb = 0; nb < kD / 8; ++nb) {
      const int c = nb * 8 + c2;
      float fold[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        fold[h] = fold_s[c + h] + fold_s[kD + c + h] + fold_s[2 * kD + c + h] +
                  fold_s[3 * kD + c + h];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + g + 8 * h;
        qown[nb][h] = add_scaled(qown[nb][h], dq[nb][2 * h] + fold[0],
                                 dq[nb][2 * h + 1] + fold[1], eps);
        *reinterpret_cast<uint32_t*>(qs + row * kLdh + c) = qown[nb][h];
        const __nv_bfloat16* pair = reinterpret_cast<const __nv_bfloat16*>(&qown[nb][h]);
        qt[c * kLdh + row] = pair[0];
        qt[(c + 1) * kLdh + row] = pair[1];
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dst = out + size_t(blockIdx.x) * kQTile;
#pragma unroll
  for (int nb = 0; nb < kD / 8; ++nb) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      *reinterpret_cast<uint32_t*>(dst + (r0 + g + 8 * h) * kD + nb * 8 + c2) = qown[nb][h];
    }
  }
}

struct AddScaledEpi {
  float scale;
  __device__ __forceinline__ uint32_t operator()(float x0, float x1, uint32_t old) const {
    return add_scaled(old, x0, x1, scale);
  }
};

__global__ void __launch_bounds__(kChainThreads, 1)
big_kernel(const __nv_bfloat16* __restrict__ x0, const __nv_bfloat16* __restrict__ w,
           __nv_bfloat16* __restrict__ out, int iters, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3), r0 = warp * 16;
  load_w_transposed(wt, w);
  uint32_t a[kChainW / 16][4];
  load_a256(a, x0 + size_t(blockIdx.x) * kChainRows * kChainW, r0, g, c2);
  __syncthreads();
  const AddScaledEpi epi{scale};
  for (int it = 0; it < iters; ++it) chain_step(a, wt, g, c2, epi, Nothing{});
  store_a256(out + size_t(blockIdx.x) * kChainRows * kChainW, a, r0, g, c2);
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
    case kFwdpair: return {reinterpret_cast<const void*>(fwdpair_kernel), kThreads, kFwdpairSmem};
    case kBwd5: return {reinterpret_cast<const void*>(bwd5_kernel), kThreads, kBwd5Smem};
    case kBig: return {reinterpret_cast<const void*>(big_kernel), kChainThreads, kWBytes};
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
