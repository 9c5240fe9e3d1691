// Block-sparse masked flash attention, backward dq (K3a), for Hopper
// (sm_90a): TMA, wgmma, warp specialisation.
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::_dq_kernel
// (the first pl.pallas_call of make_flash_attention's split _bwd_call):
// the q-major half of the split backward, with K3b (flash_bwd_dkv.cu)
// computing dk and dv.  What it computes, exactly as _dq_kernel does:
//
//   q_s = bf16(q * bf16(scale)); s = q_s k^T (fp32), blocked entries -> p = 0
//   p   = exp(s - max(lse, DEAD_CLAMP)); dp = do v^T
//   ds  = p * (dp - delta); dq = scale * sum over kv tiles of bf16(ds) k
//
// q, k, v, do and dq are [B*H, T, 64] bf16; lse and delta [B*H, T] fp32;
// the static [T, T] mask comes as pair_schedule's bits, the [B, T] key
// padding as uint8 (1 = padded key).
//
// Design: K1's dataflow (flash_fwd.cu), with its p v product turned
// into ds k.  A block owns one (b, h) and a PAIR of 64-row q tiles
// (2i, 2i + 1) and walks the pair's row of pair_schedule
// (ops/flash_attention.py): the union of the two q tiles' kv tiles, with
// a per-half `active` and `full` flag and, for a tile that is not full,
// its mask as 64 rows of 64 bits.  Blocks start longest walk first
// (pair_order, kv_pair_order of the q pairs' pair_ptr), every head of a
// pair together.  Three warpgroups:
//   - the producer: one thread TMA-loads the pair's two q tiles and two
//     do tiles once (a second tile past T reads as zeros), then each
//     item's k and v tiles (64 x 64 bf16, 3-D maps [B*H, T, 64], rows
//     past T read as zero) through a 4-stage mbarrier ring;
//   - two consumer warpgroups, one per q tile, sharing every k / v
//     stage.  Each keeps q_s (q scaled in bf16 on the way in, as the TPU
//     kernel does) and do as wgmma register-A fragments, and lse
//     (floored) and delta of its rows; s = q_s k^T and dp = do v^T are
//     wgmma m64n64k16 with k and v K-major in shared memory (K1's S
//     product twice); the mask bits and the key padding give p = 0, ds
//     is rounded to bf16 as the register A operand of dq += ds k, with k
//     read through the descriptor's transpose bit (no transposed copy).
//   - dq stays in fp32 registers for the whole walk and is written once,
//     times the scale, as bf16: the sums run in a fixed order, with no
//     atomics and no TMA reduce, so every run gives the same dq (K2 adds
//     its dq partials by TMA reduce-add, in an order that changes).
//   - Pipelining inside a consumer (K1's order): s and dp of the next
//     item are issued together with ds k of the current one, and the
//     next item's exp and ds pass run while that product is on the tensor
//     cores.  The loop body is straight-line, so that ptxas keeps the
//     wgmma pipeline: an item where this half is not active is computed
//     with every entry blocked (p = 0, so ds = 0: it adds exactly
//     nothing), and each consumer waits for and releases every item of
//     its pair in order (a parity wait cannot tell phase r of a stage
//     from r + 2).
//
// Shared memory: q and do 4 x 8 KB + k and v 4 stages x 16 KB = 96 KB, +
// 72 bytes of mbarriers + 1 KB of alignment slack.  Registers: setmaxnreg
// gives the producer 40 and each consumer 232 (q_s and do 16 each, s, dp
// and dq 32 each, ds 16).
//
// Bound on this card: three products of depth 64 per live score entry
// (s, dp, dq); at TCGA_config1 (B 8, H 8, T 2548) ~3.5e10 FLOP a layer,
// 35 us at 989 TFLOP/s bf16, against ~126 MB of q, k, v, do read and dq
// written (38 us at 3.35 TB/s): the two bounds are close.  The walk
// computes whole tiles and the idle half of a pair item: 606 half-tiles x
// 64 b*h x 3 products x 2 * 64^3 = 6.1e10 FLOP of tile work a layer.
// chip_smoke.py computes the bound for its inputs.
//
// Measured (chip_smoke.py phase 4, TCGA_config1, NVIDIA H100 80GB HBM3,
// 700.00 W): 0.2561-0.2602 ms a layer (the mma.sync version before it:
// 0.6881-0.6968 in the same call), 7.2x its bound: the tile work runs at
// ~238 TFLOP/s.
// SASS (tools/sass_counts.py): 24 HGMMA with 4 waits, 6 UTMALDG, no
// UTMAREDG, 64 MUFU.EX2, no HMMA; ptxas: 168 registers at launch, no
// spills, no wgmma serialisation.

#include "flash_tile.cuh"
#include "hopper_common.cuh"

namespace {

// kD, kBlock, the softmax constants (kDeadClamp, kLog2e): flash_tile.cuh
constexpr int kStages = 4;           // k / v ring depth
constexpr int kBlockThreads = 384;   // producer + two consumer warpgroups

constexpr uint32_t kBox = kBlock * kD * 2;  // one 64 x 64 bf16 tile, 8 KB
constexpr uint32_t kQOff = 0;
constexpr uint32_t kDoOff = 2 * kBox;
constexpr uint32_t kKOff = 4 * kBox;
constexpr uint32_t kVOff = kKOff + kStages * kBox;
constexpr uint32_t kBarOff = kVOff + kStages * kBox;
constexpr uint32_t kSmemBytes = kBarOff + (1 + 2 * kStages) * 8 + 1024;

__global__ void __launch_bounds__(kBlockThreads, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do, const float* __restrict__ lse,
                    const float* __restrict__ delta, const uint8_t* __restrict__ pad,
                    const int* __restrict__ pair_ptr, const int* __restrict__ pair_kv,
                    const int* __restrict__ pair_flags, const uint64_t* __restrict__ pair_bits,
                    const int* __restrict__ pair_order, __nv_bfloat16* __restrict__ dq,
                    int heads, int t, float scale_q, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* qdo_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  // blocks start in the order of blockIdx (x fastest): every head of the
  // longest walk first, the shortest last, so the tail wave is short
  const int pr = pair_order[blockIdx.y], bh = blockIdx.x;
  const int n0 = pair_ptr[pr], n1 = pair_ptr[pr + 1];
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
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
    if (threadIdx.x == 0 && n0 < n1) {
      // both q and do tiles, also a second one past t (TMA reads it as zeros)
      mbar_expect_tx(qdo_full, 4 * kBox);
      for (int h = 0; h < 2; ++h) {
        const int q0 = (2 * pr + h) * kBlock;
        tma_load_3d(smem + kQOff + h * kBox, &map_q, qdo_full, 0, q0, bh);
        tma_load_3d(smem + kDoOff + h * kBox, &map_do, qdo_full, 0, q0, bh);
      }
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

    // rows r0 and r0 + 8: lse (floored, so dead rows give p = 0) and
    // delta; rows past t are blocked by the mask bits
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qrow = q0 + r0 + 8 * hh;
      const bool in = qrow < t;
      lse_r[hh] = in ? fmaxf(lse[size_t(bh) * t + qrow], kDeadClamp) : 0.f;
      delta_r[hh] = in ? delta[size_t(bh) * t + qrow] : 0.f;
    }

    float dq_acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[i] = 0.f;

    if (n0 < n1) {
      // q_s (times the scale in bf16) and do as wgmma A fragments, one
      // per 16-wide step of the head dim
      mbar_wait(qdo_full, 0);
      uint32_t qa[kD / 16][4], doa[kD / 16][4];
      {
        const uint32_t q_a = smem_u32(smem + kQOff + h * kBox);
        const uint32_t do_a = smem_u32(smem + kDoOff + h * kBox);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t off = swz128(r0 + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + c2);
            qa[kk][e] = scale_bf16x2(ld_shared_u32(q_a + off), scale_q);
            doa[kk][e] = ld_shared_u32(do_a + off);
          }
        }
      }

      float s[32], dp[32];
      uint32_t dsa[kBlock / 16][4];  // ds in bf16: the A fragments of dq += ds k

      auto wait_full = [&](int n) {
        const int it = n - n0;
        mbar_wait(full + it % kStages, (it / kStages) & 1);
      };
      auto release = [&](int n) {
        if (lane == 0) mbar_arrive(empty + (n - n0) % kStages);
      };
      // s = q_s k^T and dp = do v^T of item n, issued as one group
      auto issue_sdp = [&](int n) {
        const uint32_t st = ((n - n0) % kStages) * kBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_m64n64k16_rs<0>(s, qa[kk], wgmma_desc(k_a + st + 32 * kk), kk != 0);
#pragma unroll
        for (int kk = 0; kk < kD / 16; ++kk)
          wgmma_m64n64k16_rs<0>(dp, doa[kk], wgmma_desc(v_a + st + 32 * kk), kk != 0);
        wgmma_commit();
      };
      // dq += ds k of item n from dsa: ds of key blocks 2j and 2j + 1 is
      // the A fragment of the j-th 16-key step; k's 16 rows of that step
      // are an MN-major B (transpose bit set)
      auto issue_dq = [&](int n) {
        const uint32_t kb = k_a + ((n - n0) % kStages) * kBox;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBlock / 16; ++j)
          wgmma_m64n64k16_rs<1>(dq_acc, dsa[j], wgmma_desc(kb + 2048 * j), 1);
        wgmma_commit();
      };
      // item n's ds = p (dp - delta) in place of dp, p from s (only read)
      // under the mask bits and the key padding; a half that does not
      // visit the item has every entry blocked
      auto ds_pass = [&](int n) {
        const int fl = pair_flags[n], k0 = pair_kv[n] * kBlock;
        uint64_t rb[2] = {~uint64_t(0), ~uint64_t(0)};
        if ((fl >> h) & 1) {
          rb[0] = rb[1] = 0;
          if (!((fl >> (2 + h)) & 1)) {
            const uint64_t* bits = pair_bits + (size_t(n) * 2 + h) * kBlock;
            rb[0] = bits[r0];
            rb[1] = bits[r0 + 8];
          }
        }
        uint32_t pad_even = 0, pad_odd = 0;  // lane l: keys 2l and 2l + 1
        if (pad_b != nullptr) {
          const int j = k0 + 2 * lane;
          pad_even = __ballot_sync(0xffffffffu, j >= t || pad_b[j] != 0);
          pad_odd = __ballot_sync(0xffffffffu, j + 1 >= t || pad_b[j + 1] != 0);
        }
#pragma unroll
        for (int nb = 0; nb < kBlock / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * nb + c2 + (e & 1);
            const uint32_t padded = ((e & 1) ? pad_odd : pad_even) >> (4 * nb + (lane & 3));
            const bool blocked = ((rb[e >> 1] >> c) & 1) | (padded & 1);
            const float p = blocked ? 0.f : exp2f((s[4 * nb + e] - lse_r[e >> 1]) * kLog2e);
            dp[4 * nb + e] = p * (dp[4 * nb + e] - delta_r[e >> 1]);
          }
        }
      };
      auto pack_ds = [&]() {
#pragma unroll
        for (int j = 0; j < kBlock / 16; ++j) {
          dsa[j][0] = pack_bf16x2(dp[8 * j + 0], dp[8 * j + 1]);
          dsa[j][1] = pack_bf16x2(dp[8 * j + 2], dp[8 * j + 3]);
          dsa[j][2] = pack_bf16x2(dp[8 * j + 4], dp[8 * j + 5]);
          dsa[j][3] = pack_bf16x2(dp[8 * j + 6], dp[8 * j + 7]);
        }
      };

      wait_full(n0);
      issue_sdp(n0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      ds_pass(n0);
      pack_ds();
      for (int n = n0; n + 1 < n1; ++n) {
        wait_full(n + 1);
        issue_sdp(n + 1);
        issue_dq(n);
        wgmma_wait<1>();  // s and dp of n + 1 are done, ds k of n may still run
        fence_regs(s);
        fence_regs(dp);
        ds_pass(n + 1);
        wgmma_wait<0>();
        fence_regs(dq_acc);
        release(n);
        pack_ds();
      }
      issue_dq(n1 - 1);
      wgmma_wait<0>();
      fence_regs(dq_acc);
      release(n1 - 1);
    }

    // dq (times the scale) of this thread's rows, once, as bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int qrow = q0 + r0 + 8 * hh;
      if (qrow >= t) continue;
      __nv_bfloat16* dqrow = dq + head_off + size_t(qrow) * kD;
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        *reinterpret_cast<uint32_t*>(dqrow + 8 * nb + c2) = pack_bf16x2(
            scale * dq_acc[4 * nb + 2 * hh], scale * dq_acc[4 * nb + 2 * hh + 1]);
      }
    }
  }
}

}  // namespace

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, dout, dq: [bh, t, 64] bf16; lse, delta: [bh, t] fp32; pad:
// [bh / heads, t] uint8 or null; pair_ptr: [n_pairs + 1] int32; pair_kv,
// pair_flags: [pair_ptr[n_pairs]] int32; pair_bits: [pair_ptr[n_pairs],
// 2, 64] uint64; pair_order: [n_pairs] int32 (ops/flash_attention.py
// pair_schedule and kv_pair_order).  scale_q: the scale rounded to bf16,
// folded into q; scale: the scale dq is multiplied by.  Encodes the four
// tensor maps, launches on `stream`, does not synchronise, returns
// cudaGetLastError() (or cudaErrorInvalidValue when
// cuTensorMapEncodeTiled refuses a map).
extern "C" int mca_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, const void* pad,
                                const void* pair_ptr, const void* pair_kv,
                                const void* pair_flags, const void* pair_bits,
                                const void* pair_order, void* dq, int bh, int heads, int t,
                                int n_pairs, float scale_q, float scale, void* stream) {
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, dout};
  const uint64_t dims[3] = {uint64_t(kD), uint64_t(t), uint64_t(bh)};
  const uint64_t strides[2] = {kD * 2, uint64_t(t) * kD * 2};
  const uint32_t box[3] = {kD, kBlock, 1};
  for (int i = 0; i < 4; ++i)
    if (!make_map(&maps[i], bases[i], 3, dims, strides, box)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(kSmemBytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(bh, n_pairs);
  flash_bwd_dq_kernel<<<grid, kBlockThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(pad),
      static_cast<const int*>(pair_ptr), static_cast<const int*>(pair_kv),
      static_cast<const int*>(pair_flags), static_cast<const uint64_t*>(pair_bits),
      static_cast<const int*>(pair_order), static_cast<__nv_bfloat16*>(dq), heads, t, scale_q,
      scale);
  return int(cudaGetLastError());
}
