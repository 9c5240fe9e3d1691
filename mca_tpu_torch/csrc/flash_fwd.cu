// Block-sparse masked flash attention, forward, for Hopper (sm_90a): TMA,
// wgmma, warp specialisation (FlashAttention-3's forward, adapted to a
// static mask).
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::_fwd_kernel
// (launched through pl.pallas_call in make_flash_attention's _fwd_call).
//
// What it computes, exactly as _fwd_kernel does:
//   - q, k, v: [B*H, T, 64] bf16, contiguous; out [B*H, T, 64] bf16 and
//     lse [B*H, T] fp32;
//   - a static [T, T] mask (1 = blocked) shared by batch and heads, and a
//     dynamic [B, T] key padding mask (1 = padded key, uint8);
//   - the softmax scale rounded to bf16 and folded into q in bf16, fp32
//     scores, running max and sum, exp2 with log2(e) folded in, p
//     rounded to bf16 for the p.v product with fp32 accumulation;
//   - the running max floored at DEAD_CLAMP = -1e29, so a fully masked
//     row gives p = 0 everywhere; such rows return out = 0 and
//     lse = NEG_INF (-1e30).
//
// Design.  The TPU kernel walks a sequential (bh, tile) grid and carries
// the online-softmax state in scratch.  Here a block owns one (b, h) and
// a PAIR of 64-row q tiles (2i, 2i + 1) and walks the pair's row of a
// CSR schedule built once per static mask on the host
// (ops/flash_attention.py pair_schedule): the union of the two q tiles'
// kv tiles, each with a per-half `active` and `full` flag and, for a
// tile that is not full, its mask as 64 rows of 64 bits.  Tiles the mask
// blocks for both halves are never visited.  Three warpgroups:
//   - the producer: one thread TMA-loads the two q tiles, then each
//     visited kv tile's k and v (64 x 64 bf16 each, 3-D maps [B*H, T,
//     64] so a box never crosses heads; rows past T read as zero)
//     through a 4-stage mbarrier ring;
//   - two consumer warpgroups, one per q tile, sharing every k / v stage
//     both need.  Each keeps its q rows as wgmma A fragments in registers
//     (scaled in bf16 on the way in, as the TPU kernel does), computes
//     S = (scale q) k^T with wgmma m64n64k16 (k in its natural K-major
//     layout), applies the mask bits and the key padding (one 64-byte
//     load and two ballots a warp) and the online softmax on the
//     accumulators in place (a warp's slice of a wgmma accumulator is
//     the mma.sync m16n8 layout repeated along N, so a row's entries sit
//     in a quad), and adds p v with wgmma, p rounded to bf16 as the
//     register A operand and v read through the descriptor's transpose
//     bit (no transposed copy).
//   - Pipelining inside a warpgroup (FlashAttention-3's order): S of the
//     next visited tile is issued together with p v of the current one,
//     and the next tile's softmax runs while that p v is on the tensor
//     cores (the in-warp overlap the overlap probe measured).  The loop
//     body is straight-line (two commits, two waits) so that ptxas keeps
//     the wgmma pipeline.  A half also waits for and releases the tiles
//     it skips, in order (a parity wait cannot tell phase r of a stage
//     from r + 2), and looks ahead only as far as the ring holds, so it
//     cannot deadlock.
//
// Shared memory: q 2 x 8 KB + k and v 4 stages x 16 KB = 80 KB, + 72
// bytes of mbarriers + 1 KB of alignment slack.  Registers: setmaxnreg
// gives the producer 40 and each consumer 232.
//
// Bound on this card: at TCGA_config1 (B 8, H 8, T 2548) the static mask
// and the padding leave ~9.1e7 score entries a layer: ~23 GFLOP for both
// products (24 us at 989 TFLOP/s bf16), while q, k, v and out are 84 MB
// (25 us at 3.35 TB/s).  chip_smoke.py computes both for its inputs.
//
// Measured (chip_smoke.py phase 2, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.2834 ms a layer (the mma.sync version before it took 0.646 ms;
// SDPA under the same mask 0.5647 ms).  SASS (tools/sass_counts.py): 16
// HGMMA, 4 UTMALDG, 68 MUFU.EX2, no HMMA; ptxas: 168 registers at
// launch, no spills, and no wgmma serialisation warning (C7514 / C7515:
// an earlier loop that issued the next S before the softmax, with the
// lookahead conditional, was serialised by ptxas and took 0.354 ms).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

// kD, kBlock and the softmax constants (kNegInf, kDeadClamp, kLog2e),
// quad_max and quad_sum are the backward kernels', from flash_common.cuh
constexpr int kStages = 4;           // k / v ring depth
constexpr int kBlockThreads = 384;   // producer + two consumer warpgroups

constexpr uint32_t kBox = kBlock * kD * 2;  // one 64 x 64 bf16 tile, 8 KB
constexpr uint32_t kQOff = 0;
constexpr uint32_t kKOff = 2 * kBox;
constexpr uint32_t kVOff = kKOff + kStages * kBox;
constexpr uint32_t kBarOff = kVOff + kStages * kBox;
constexpr uint32_t kSmemBytes = kBarOff + (1 + 2 * kStages) * 8 + 1024;

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// two bf16 times the scale, each rounded to bf16 (load_row8's q * scale)
__device__ __forceinline__ uint32_t scale_bf16x2(uint32_t v, float scale) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  return pack_bf16x2(f.x * scale, f.y * scale);
}

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const uint8_t* __restrict__ pad,
                 const int* __restrict__ pair_ptr, const int* __restrict__ pair_kv,
                 const int* __restrict__ pair_flags, const uint64_t* __restrict__ pair_bits,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse, int heads, int t,
                 float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int pr = blockIdx.x, bh = blockIdx.y;
  const int n0 = pair_ptr[pr], n1 = pair_ptr[pr + 1];
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      const bool second = 2 * pr * kBlock + kBlock < t;  // q tile 2i + 1 exists
      mbar_expect_tx(q_full, second ? 2 * kBox : kBox);
      tma_load_3d(smem + kQOff, &map_q, q_full, 0, 2 * pr * kBlock, bh);
      if (second) tma_load_3d(smem + kQOff + kBox, &map_q, q_full, 0, (2 * pr + 1) * kBlock, bh);
      for (int n = n0; n < n1; ++n) {
        const int it = n - n0, st = it % kStages;
        mbar_wait(empty + st, ((it / kStages) & 1) ^ 1);
        mbar_expect_tx(full + st, 2 * kBox);
        const int k0 = pair_kv[n] * kBlock;
        tma_load_3d(smem + kKOff + st * kBox, &map_k, full + st, 0, k0, bh);
        tma_load_3d(smem + kVOff + st * kBox, &map_v, full + st, 0, k0, bh);
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<232>();
    const int h = wg - 1;                   // q tile 2 pr + h
    const int wl = (threadIdx.x / 32) % 4;  // rows 16 wl.. of the tile
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const int r0 = 16 * wl + g;             // this thread's rows: r0, r0 + 8
    const int q0 = (2 * pr + h) * kBlock;
    const size_t head_off = size_t(bh) * t * kD;
    const uint8_t* pad_b = pad ? pad + size_t(bh / heads) * t : nullptr;
    const uint32_t k_a = smem_u32(smem + kKOff), v_a = smem_u32(smem + kVOff);

    // q as wgmma A fragments (one per 16-wide step of the head dim),
    // times the scale in bf16
    mbar_wait(q_full, 0);
    uint32_t qa[kD / 16][4];
    {
      const uint32_t q_a = smem_u32(smem + kQOff + h * kBox);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        qa[kk][0] = scale_bf16x2(ld_shared_u32(q_a + swz128(r0, 16 * kk + c2)), scale);
        qa[kk][1] = scale_bf16x2(ld_shared_u32(q_a + swz128(r0 + 8, 16 * kk + c2)), scale);
        qa[kk][2] = scale_bf16x2(ld_shared_u32(q_a + swz128(r0, 16 * kk + 8 + c2)), scale);
        qa[kk][3] = scale_bf16x2(ld_shared_u32(q_a + swz128(r0 + 8, 16 * kk + 8 + c2)), scale);
      }
    }

    // rows r0 and r0 + 8: running max, this thread's share of the running
    // sum, and O (8 column blocks of 8, accumulator layout)
    float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
    float o[32], s[32], p[32], corr[2];
    uint32_t pa[kBlock / 16][4];  // p in bf16: the A fragments of O += p v
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;

    auto active = [&](int n) { return (pair_flags[n] >> h) & 1; };
    auto wait_full = [&](int n) {
      const int it = n - n0;
      mbar_wait(full + it % kStages, (it / kStages) & 1);
    };
    auto release = [&](int n) {
      if (lane == 0) mbar_arrive(empty + (n - n0) % kStages);
    };
    // A half waits for and releases the items it skips too, in order: a
    // wait on a stage's barrier then never lags the barrier by more than
    // one phase (a parity wait cannot tell phase r from r + 2).  From j
    // on, while the ring allows it (j - held < kStages; held < 0: no
    // stage held), returns the first item not skipped.
    auto skip = [&](int j, int held) {
      while (j < n1 && !active(j) && (held < 0 || j - held < kStages)) {
        wait_full(j);
        release(j);
        ++j;
      }
      return j;
    };
    // S = (scale q) k^T of item n into s, issued, not waited for
    auto issue_s = [&](int n) {
      const uint32_t kb = k_a + ((n - n0) % kStages) * kBox;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_rs<0>(s, qa[kk], wgmma_desc(kb + 32 * kk), kk != 0);
      wgmma_commit();
    };
    // O += p v of item n from pa, issued, not waited for: the
    // probabilities of key blocks 2j and 2j + 1 are the A fragment of the
    // j-th 16-key step; v's 16 rows of that step are an MN-major B
    // (transpose bit set)
    auto issue_pv = [&](int n) {
      const uint32_t vb = v_a + ((n - n0) % kStages) * kBox;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j)
        wgmma_m64n64k16_rs<1>(o, pa[j], wgmma_desc(vb + 2048 * j), 1);
      wgmma_commit();
    };
    // masks and the online softmax of item n's scores (s is only read):
    // p, the running max and sum, and corr, by which O is to be rescaled
    auto softmax = [&](int n) {
      const int fl = pair_flags[n], k0 = pair_kv[n] * kBlock;
      const bool tile_full = (fl >> (2 + h)) & 1;
      uint64_t rb[2] = {0, 0};
      if (!tile_full) {
        const uint64_t* bits = pair_bits + (size_t(n) * 2 + h) * kBlock;
        rb[0] = bits[r0];
        rb[1] = bits[r0 + 8];
      }
      uint32_t pad_even = 0, pad_odd = 0;  // lane l: keys 2l and 2l + 1
      if (pad_b != nullptr) {
        const int j = k0 + 2 * lane;
        pad_even = __ballot_sync(0xffffffffu, j >= t || pad_b[j] != 0);
        pad_odd = __ballot_sync(0xffffffffu, j + 1 >= t || pad_b[j + 1] != 0);
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nb + c2 + (e & 1);
          const uint32_t padded = ((e & 1) ? pad_odd : pad_even) >> (4 * nb + (lane & 3));
          const bool blocked = ((rb[e >> 1] >> c) & 1) | (padded & 1);
          p[4 * nb + e] = blocked ? kNegInf : s[4 * nb + e];
          mx[e >> 1] = fmaxf(mx[e >> 1], p[4 * nb + e]);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float m_new = fmaxf(fmaxf(m_run[hh], quad_max(mx[hh])), kDeadClamp);
        corr[hh] = exp2f((m_run[hh] - m_new) * kLog2e);
        m_run[hh] = m_new;
        l_run[hh] *= corr[hh];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        p[i] = exp2f((p[i] - m_run[(i >> 1) & 1]) * kLog2e);
        l_run[(i >> 1) & 1] += p[i];
      }
    };
    // O rescaled by corr, p rounded to bf16 into pa (no p v in flight)
    auto rescale_pack = [&]() {
#pragma unroll
      for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j) {
        pa[j][0] = pack_bf16x2(p[8 * j + 0], p[8 * j + 1]);
        pa[j][1] = pack_bf16x2(p[8 * j + 2], p[8 * j + 3]);
        pa[j][2] = pack_bf16x2(p[8 * j + 4], p[8 * j + 5]);
        pa[j][3] = pack_bf16x2(p[8 * j + 6], p[8 * j + 7]);
      }
    };

    // Runs of items this half visits back to back.  Inside a run the S
    // of the next item is issued with the p v of the current one, and
    // the next softmax runs while that p v is on the tensor cores.  A run
    // ends where the next visited item is a ring's length away (only the
    // other half's items in between) or at the end of the pair.
    int cur = skip(n0, -1);
    while (cur < n1) {
      wait_full(cur);
      issue_s(cur);
      wgmma_wait<0>();
      fence_regs(s);
      softmax(cur);
      rescale_pack();
      int nxt;
      while (true) {
        nxt = skip(cur + 1, cur);
        if (nxt >= n1 || !active(nxt) || nxt - cur >= kStages) break;
        wait_full(nxt);
        issue_s(nxt);
        issue_pv(cur);
        wgmma_wait<1>();  // S(nxt) is done, p v (cur) may still run
        fence_regs(s);
        softmax(nxt);
        wgmma_wait<0>();
        fence_regs(o);
        release(cur);
        rescale_pack();
        cur = nxt;
      }
      issue_pv(cur);
      wgmma_wait<0>();
      fence_regs(o);
      release(cur);
      cur = skip(nxt, -1);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qrow = q0 + r0 + 8 * hh;
      const float l = quad_sum(l_run[hh]);
      if (qrow >= t) continue;
      __nv_bfloat16* orow = out + head_off + size_t(qrow) * kD;
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        const float x0 = l > 0.f ? o[4 * nb + 2 * hh] / l : 0.f;
        const float x1 = l > 0.f ? o[4 * nb + 2 * hh + 1] / l : 0.f;
        *reinterpret_cast<uint32_t*>(orow + 8 * nb + c2) = pack_bf16x2(x0, x1);
      }
      if ((lane & 3) == 0) lse[size_t(bh) * t + qrow] = l > 0.f ? m_run[hh] + logf(l) : kNegInf;
    }
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, out: [bh, t, 64] bf16; lse: [bh, t] fp32; pad: [bh / heads,
// t] uint8 or null; pair_ptr: [n_pairs + 1] int32; pair_kv, pair_flags:
// [pair_ptr[n_pairs]] int32; pair_bits: [pair_ptr[n_pairs], 2, 64]
// uint64 (ops/flash_attention.py pair_schedule).  Encodes the three
// tensor maps, launches on `stream`, does not synchronise, returns
// cudaGetLastError() (or cudaErrorInvalidValue when
// cuTensorMapEncodeTiled refuses a map).
extern "C" int mca_flash_fwd(const void* q, const void* k, const void* v, const void* pad,
                             const void* pair_ptr, const void* pair_kv, const void* pair_flags,
                             const void* pair_bits, void* out, void* lse, int bh, int heads,
                             int t, int n_pairs, float scale, void* stream) {
  CUtensorMap maps[3];
  const void* bases[3] = {q, k, v};
  const uint64_t dims[3] = {uint64_t(kD), uint64_t(t), uint64_t(bh)};
  const uint64_t strides[2] = {kD * 2, uint64_t(t) * kD * 2};
  const uint32_t box[3] = {kD, kBlock, 1};
  for (int i = 0; i < 3; ++i)
    if (!make_map(&maps[i], bases[i], 3, dims, strides, box)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_pairs, bh);
  flash_fwd_kernel<<<grid, kBlockThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], static_cast<const uint8_t*>(pad),
      static_cast<const int*>(pair_ptr), static_cast<const int*>(pair_kv),
      static_cast<const int*>(pair_flags), static_cast<const uint64_t*>(pair_bits),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), heads, t, scale);
  return int(cudaGetLastError());
}
