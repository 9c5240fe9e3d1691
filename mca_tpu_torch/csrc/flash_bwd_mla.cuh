// The fused flash-attention backward (K2) at latent attention's head
// dims, d_qk = 192 (128 nope + 64 rope) and d_v = 128, for Hopper
// (sm_90a): TMA, wgmma, warp specialisation.  It computes what
// flash_bwd_kv.cuh's K2 computes, over the same kv_pair_schedule,
// pair_order, key padding and scales:
//
//   q_s = bf16(q * bf16(scale))   (or q with scale_s, as K2)
//   s   = q_s k^T in fp32, blocked entries -> p = 0
//   p   = exp(s - max(lse, DEAD_CLAMP))
//   dv += bf16(p)^T do,  dp = do v^T,  ds = p * (dp - delta)
//   dk += bf16(ds)^T q_s,  dq += scale * bf16(ds) k
//
// Why another body.  K2 gives each consumer warpgroup one 64-key tile and
// keeps its dk and dv as wgmma accumulators for the whole walk: at 64 x
// (64 + 64) that is 64 registers a thread, and with s, dp and the bf16
// fragments the 160 that fit the 168 a thread of a 384-thread block
// holds.  At 64 x (192 + 128) the accumulators alone would be 160.  So
// here both consumers work on ONE kv tile of the pair at a time and
// split its accumulators by 32-column unit: dk has six units, dv four,
// the dq partial six.  Role 0 holds dk units 0-3 and dv unit 0 (80
// registers) and computes dq units 0-2; role 1 holds dk units 4-5 and dv
// units 1-3 (80) and computes dq units 3-5: 256 columns of products
// each an item.  Each consumer computes the item's whole s^T and dp^T
// (both need every column of the tile), the price of the split: 20 of
// the 36 k-steps of 64 columns a consumer issues per item repeat the
// other's.  The scores are taken in two halves of 32 queries (32
// registers of s^T and dp^T at a time), and p^T and ds^T go to shared
// memory at once (bf16), where their products read them: with the 80
// accumulators a consumer stays within 168 registers, no spill (ptxas
// caps this kernel's consumers there, as it does K2's).
//
// Walk.  A block owns one (b, h) and a pair of kv tiles (2j, 2j + 1) as
// in K2, and walks the pair's row of the schedule twice, once a tile,
// visiting only the items live for that tile (so the tile that is not
// live costs nothing here, where K2 computes it masked).  The producer
// warp loads the tile's k (three 64-column boxes) and v (two) once a
// phase, after both consumers released the previous tile, and each
// visited item's q (three boxes) and do (two) through a 2-stage ring of
// 40 KB stages, with lse and delta beside them.  Each consumer keeps its
// own ds^T tile (no barrier between the consumers), and adds its dq
// units, times the scale, into the fp32 [B*H, T, 192] buffer by TMA
// reduce-add (a 32-column box each) from one staging buffer.
//
// Measured (NVIDIA H100 80GB HBM3, 700.00 W): 1.076 ms a call at B 2,
// H 16, T 2548 on TCGA_config1's mask with key padding, the delta, the
// dq buffer's zeroing and cast included (K2 at 64: 0.196 ms at H 8);
// ptxas: 168 registers, no spill, no wgmma serialisation.
//
// Shared memory: k and v 40 KB, the ring 80 KB, two p^T and two ds^T
// tiles 32 KB, dq staging 48 KB (three 32-column units a role), lse /
// delta 1 KB.

#pragma once

#include "flash_tile.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kMlaDqk = 192, kMlaDv = 128;
constexpr int kMlaQBoxes = kMlaDqk / kD, kMlaVBoxes = kMlaDv / kD;
constexpr int kMlaStages = 2;       // q / do ring depth
constexpr int kMlaThreads = 384;    // producer + two consumer warpgroups
constexpr uint32_t kMlaBox = kBlock * kD * 2;     // one 64 x 64 bf16 box, 8 KB
constexpr uint32_t kMlaUnit = kBlock * 32 * 4;    // one 64 x 32 fp32 dq unit, 8 KB

struct MlaSmem {
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + kMlaQBoxes * kMlaBox;
  static constexpr uint32_t q = v + kMlaVBoxes * kMlaBox;
  static constexpr uint32_t dout = q + kMlaStages * kMlaQBoxes * kMlaBox;
  static constexpr uint32_t ds = dout + kMlaStages * kMlaVBoxes * kMlaBox;
  static constexpr uint32_t pt = ds + 2 * kMlaBox;  // a p^T tile a role
  static constexpr uint32_t dq = pt + 2 * kMlaBox;  // three units a role
  static constexpr uint32_t stats = dq + 2 * 3 * kMlaUnit;
  static constexpr uint32_t bars = stats + kMlaStages * 2 * kBlock * 4;
  static constexpr uint32_t bytes = bars + (2 + 2 * kMlaStages) * 8 + 1024;
};
static_assert(MlaSmem::bytes <= 227 * 1024, "shared memory of one block");

// d[16] (+)= A[64 x 16] * B[16 x 32], both from shared memory
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t desc_a,
                                                  uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15} "
      ", "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TRANS_A), "n"(TRANS_B));
}

// What a consumer role holds, in 32-column units of a 64-column box:
// whole dk boxes [kDk0, kDk0 + kNDk); half kRole of dv box 0, and, for
// role 1, dv box 1 whole; dq box kDqFull whole and half kRole of dq box 1.
template <int kRole>
struct MlaRole {
  static constexpr int kDk0 = kRole == 0 ? 0 : 2, kNDk = kRole == 0 ? 2 : 1;
  static constexpr bool kDvFull = kRole == 1;
  static constexpr int kDqFull = kRole == 0 ? 0 : 2;
  static constexpr uint32_t kHalf = 64 * kRole;  // bytes into a 128-byte row
};

template <int kRole>
__device__ __forceinline__ void mla_bwd_consumer(
    unsigned char* smem, const CUtensorMap* map_dq, const float* stats, uint64_t* kv_full,
    uint64_t* kv_empty, uint64_t* full, uint64_t* empty, const uint8_t* __restrict__ pad,
    const int* __restrict__ pair_q, const int* __restrict__ pair_flags,
    const uint64_t* __restrict__ pair_bits, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int pr, int bh, int n0, int n1, int heads, int t,
    float scale_s, float scale_dq) {
  using R = MlaRole<kRole>;
  using L = MlaSmem;
  const int tid = threadIdx.x % 128;
  const int wl = tid / 32, lane = tid % 32;
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int r0 = 16 * wl + g;  // this thread's keys in the tile: r0, r0 + 8
  const uint32_t k_a = smem_u32(smem + L::k), v_a = smem_u32(smem + L::v);
  const uint32_t q_a = smem_u32(smem + L::q), do_a = smem_u32(smem + L::dout);
  const uint32_t ds_a = smem_u32(smem + L::ds + kRole * kMlaBox);
  const uint32_t pt_a = smem_u32(smem + L::pt + kRole * kMlaBox);
  const uint32_t dq_a = smem_u32(smem + L::dq + kRole * 3 * kMlaUnit);
  const uint8_t* pad_b = pad ? pad + size_t(bh / heads) * t : nullptr;

  float dk_acc[R::kNDk][32], dv_half[16], dv_full[R::kDvFull ? 32 : 1];
  float s[16], dp[16], dq_full[32], dq_half[16];
  // a 64 x 32 accumulator half (rows = keys, queries 32 half..) as bf16
  // into columns 32 half.. of a 128-byte-swizzled 64 x 64 shared tile
  auto store_half = [&](uint32_t tile, const float (&x)[16], int half) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 32 * half + 16 * j + c2;
      st_shared_u32(tile + swz128(r0, col), pack_bf16x2(x[8 * j + 0], x[8 * j + 1]));
      st_shared_u32(tile + swz128(r0 + 8, col), pack_bf16x2(x[8 * j + 2], x[8 * j + 3]));
      st_shared_u32(tile + swz128(r0, col + 8), pack_bf16x2(x[8 * j + 4], x[8 * j + 5]));
      st_shared_u32(tile + swz128(r0 + 8, col + 8), pack_bf16x2(x[8 * j + 6], x[8 * j + 7]));
    }
  };
  int it = 0;  // items taken from the ring, over both phases
  for (int h = 0; h < 2; ++h) {
    const int k0 = (2 * pr + h) * kBlock;
    bool keyblk[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = k0 + r0 + 8 * hh;
      keyblk[hh] = j >= t || (pad_b != nullptr && pad_b[j] != 0);
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
#pragma unroll
      for (int c = 0; c < R::kNDk; ++c) dk_acc[c][i] = 0.f;
      if constexpr (R::kDvFull) dv_full[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) dv_half[i] = 0.f;
    mbar_wait(kv_full, h);

    for (int n = n0; n < n1; ++n) {
      const int fl = pair_flags[n];
      if (!((fl >> h) & 1)) continue;
      const int st = it % kMlaStages;
      const uint32_t par = (it / kMlaStages) & 1;
      ++it;
      // the tile's shared addresses, made opaque an item: ptxas would
      // otherwise hoist each item's forty-odd loop-invariant wgmma
      // descriptors out of the loop and run out of registers
      uint32_t k_t = k_a, v_t = v_a, ds_t = ds_a, pt_t = pt_a;
      asm volatile("" : "+r"(k_t), "+r"(v_t), "+r"(ds_t), "+r"(pt_t));
      uint64_t rb[2] = {0, 0};
      if (!((fl >> (2 + h)) & 1)) {
        const uint64_t* bits = pair_bits + (size_t(n) * 2 + h) * kBlock;
        rb[0] = bits[r0];
        rb[1] = bits[r0 + 8];
      }
      if (keyblk[0]) rb[0] = ~uint64_t(0);
      if (keyblk[1]) rb[1] = ~uint64_t(0);
      const float* sl = stats + st * 2 * kBlock;
      const uint32_t qb = q_a + st * kMlaQBoxes * kMlaBox;
      const uint32_t dob = do_a + st * kMlaVBoxes * kMlaBox;
      mbar_wait(full + st, par);

      // Two halves of 32 queries: s^T = k q_s^T (192 deep) and dp^T = v
      // do^T (128 deep), rows = keys, all operands K-major in shared
      // memory; then p^T and ds^T = p^T (dp^T - delta) into this role's
      // p^T and ds^T tiles (bf16).  A half keeps 32 registers of scores,
      // where the whole item would keep 64 beside the 80 accumulators.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t rows = 32 * half * 128;  // this half's q and do rows
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < kMlaQBoxes; ++c)
#pragma unroll
          for (int kk = 0; kk < kD / 16; ++kk)
            wgmma_m64n32k16_ss<0, 0>(s, wgmma_desc(k_t + c * kMlaBox + 32 * kk),
                                     wgmma_desc(qb + c * kMlaBox + rows + 32 * kk),
                                     (c | kk) != 0);
        wgmma_commit();
#pragma unroll
        for (int c = 0; c < kMlaVBoxes; ++c)
#pragma unroll
          for (int kk = 0; kk < kD / 16; ++kk)
            wgmma_m64n32k16_ss<0, 0>(dp, wgmma_desc(v_t + c * kMlaBox + 32 * kk),
                                     wgmma_desc(dob + c * kMlaBox + rows + 32 * kk),
                                     (c | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const float2 l2 = *reinterpret_cast<const float2*>(sl + 32 * half + 8 * nb + c2);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 32 * half + 8 * nb + c2 + (e & 1);
            const bool blocked = (rb[e >> 1] >> c) & 1;
            const float x = (s[4 * nb + e] * scale_s - ((e & 1) ? l2.y : l2.x)) * kLog2e;
            s[4 * nb + e] = blocked ? 0.f : exp2f(x);
          }
        }
        store_half(pt_t, s, half);
        wgmma_wait<0>();
        fence_regs(dp);
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(sl + kBlock + 32 * half + 8 * nb + c2);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * nb + e] = s[4 * nb + e] * (dp[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
        }
        store_half(ds_t, dp, half);
      }
      fence_async_smem();
      named_barrier(1 + kRole, 128);  // every warp's p^T and ds^T rows are stored

      // this role's dv += p^T do and dk += ds^T q_s: A K-major from the
      // tiles, do and q read MN-major, 16 queries a step
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j) {
        wgmma_m64n32k16_ss<0, 1>(dv_half, wgmma_desc(pt_t + 32 * j),
                                 wgmma_desc(dob + R::kHalf + 2048 * j), 1);
        if constexpr (R::kDvFull)
          wgmma_m64n64k16_ss<0, 1>(dv_full, wgmma_desc(pt_t + 32 * j),
                                   wgmma_desc(dob + kMlaBox + 2048 * j), 1);
      }
#pragma unroll
      for (int c = 0; c < R::kNDk; ++c)
#pragma unroll
        for (int j = 0; j < kBlock / 16; ++j)
          wgmma_m64n64k16_ss<0, 1>(dk_acc[c], wgmma_desc(ds_t + 32 * j),
                                   wgmma_desc(qb + (R::kDk0 + c) * kMlaBox + 2048 * j), 1);
      wgmma_commit();

      // dq partial = ds k: rows = queries; A = ds^T read MN-major, B =
      // k's box read MN-major, 16 keys a step; this role's whole box into
      // dq_full, its half of box 1 into dq_half
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j) {
        wgmma_m64n64k16_ss<1, 1>(dq_full, wgmma_desc(ds_t + 2048 * j),
                                 wgmma_desc(k_t + R::kDqFull * kMlaBox + 2048 * j), j != 0);
        wgmma_m64n32k16_ss<1, 1>(dq_half, wgmma_desc(ds_t + 2048 * j),
                                 wgmma_desc(k_t + kMlaBox + R::kHalf + 2048 * j), j != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_half);
      if constexpr (R::kDvFull) fence_regs(dv_full);
#pragma unroll
      for (int c = 0; c < R::kNDk; ++c) fence_regs(dk_acc[c]);
      fence_regs(dq_full);
      fence_regs(dq_half);
      if (lane == 0) mbar_arrive(empty + st);  // q, do, lse, delta read

      // the partials, times the scale, into the staging buffer (three
      // 32-column units, 128-byte swizzle) once the previous item's
      // reduce has read it; one thread adds them into dq
      if (tid == 0) bulk_wait_read<0>();
      named_barrier(1 + kRole, 128);
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        const uint32_t unit = dq_a + (nb / 4) * kMlaUnit;
        const int col = 8 * (nb % 4) + c2;
        st_shared_f32x2(unit + swz128_f32(r0, col), scale_dq * dq_full[4 * nb],
                        scale_dq * dq_full[4 * nb + 1]);
        st_shared_f32x2(unit + swz128_f32(r0 + 8, col), scale_dq * dq_full[4 * nb + 2],
                        scale_dq * dq_full[4 * nb + 3]);
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const uint32_t unit = dq_a + 2 * kMlaUnit;
        const int col = 8 * nb + c2;
        st_shared_f32x2(unit + swz128_f32(r0, col), scale_dq * dq_half[4 * nb],
                        scale_dq * dq_half[4 * nb + 1]);
        st_shared_f32x2(unit + swz128_f32(r0 + 8, col), scale_dq * dq_half[4 * nb + 2],
                        scale_dq * dq_half[4 * nb + 3]);
      }
      fence_async_smem();
      named_barrier(1 + kRole, 128);
      if (tid == 0) {
        const int q0 = pair_q[n] * kBlock;
        tma_reduce_add_3d(map_dq, dq_a, R::kDqFull * kD, q0, bh);
        tma_reduce_add_3d(map_dq, dq_a + kMlaUnit, R::kDqFull * kD + 32, q0, bh);
        tma_reduce_add_3d(map_dq, dq_a + 2 * kMlaUnit, kD + 32 * kRole, q0, bh);
        bulk_commit();
      }
    }
    // this warp is done with the tile's k and v
    if (lane == 0) mbar_arrive(kv_empty);

    // dk (times scale_s) and dv of this thread's keys in this role's
    // units, once, as bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + r0 + 8 * hh;
      if (key >= t) continue;
      __nv_bfloat16* dkrow = dk + (size_t(bh) * t + key) * kMlaDqk;
      __nv_bfloat16* dvrow = dv + (size_t(bh) * t + key) * kMlaDv;
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
#pragma unroll
        for (int c = 0; c < R::kNDk; ++c)
          *reinterpret_cast<uint32_t*>(dkrow + (R::kDk0 + c) * kD + 8 * nb + c2) =
              pack_bf16x2(scale_s * dk_acc[c][4 * nb + 2 * hh],
                          scale_s * dk_acc[c][4 * nb + 2 * hh + 1]);
        if constexpr (R::kDvFull)
          *reinterpret_cast<uint32_t*>(dvrow + kD + 8 * nb + c2) =
              pack_bf16x2(dv_full[4 * nb + 2 * hh], dv_full[4 * nb + 2 * hh + 1]);
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        *reinterpret_cast<uint32_t*>(dvrow + 32 * kRole + 8 * nb + c2) =
            pack_bf16x2(dv_half[4 * nb + 2 * hh], dv_half[4 * nb + 2 * hh + 1]);
    }
  }
  if (tid == 0) bulk_wait<0>();
}

__global__ void __launch_bounds__(kMlaThreads, 1)
flash_bwd_mla_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const __grid_constant__ CUtensorMap map_dq, const float* __restrict__ lse,
                     const float* __restrict__ delta, const uint8_t* __restrict__ pad,
                     const int* __restrict__ pair_ptr, const int* __restrict__ pair_q,
                     const int* __restrict__ pair_flags, const uint64_t* __restrict__ pair_bits,
                     const int* __restrict__ pair_order, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int heads, int t, float scale_s,
                     float scale_dq) {
  using L = MlaSmem;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = bars + 2 + kMlaStages;
  float* stats = reinterpret_cast<float*>(smem + L::stats);  // per stage: lse[64], delta[64]

  const int pr = pair_order[blockIdx.y], bh = blockIdx.x;
  const int n0 = pair_ptr[pr], n1 = pair_ptr[pr + 1];
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 8);  // one arrival per consumer warp
    for (int s = 0; s < kMlaStages; ++s) {
      mbar_init(full + s, 32);  // the producer warp's lanes
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<40>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const float* lse_h = lse + size_t(bh) * t;
      const float* delta_h = delta + size_t(bh) * t;
      int it = 0;
      for (int h = 0; h < 2; ++h) {
        const int k0 = (2 * pr + h) * kBlock;
        if (h == 1) mbar_wait(kv_empty, 0);  // both consumers left tile 0
        if (lane == 0) {
          // rows past t read as zeros
          mbar_expect_tx(kv_full, (kMlaQBoxes + kMlaVBoxes) * kMlaBox);
          for (int c = 0; c < kMlaQBoxes; ++c)
            tma_load_3d(smem + L::k + c * kMlaBox, &map_k, kv_full, c * kD, k0, bh);
          for (int c = 0; c < kMlaVBoxes; ++c)
            tma_load_3d(smem + L::v + c * kMlaBox, &map_v, kv_full, c * kD, k0, bh);
        }
        for (int n = n0; n < n1; ++n) {
          if (!((pair_flags[n] >> h) & 1)) continue;
          const int st = it % kMlaStages;
          mbar_wait(empty + st, ((it / kMlaStages) & 1) ^ 1);
          ++it;
          const int q0 = pair_q[n] * kBlock;
          if (lane == 0) {
            mbar_expect_tx_only(full + st, (kMlaQBoxes + kMlaVBoxes) * kMlaBox);
            for (int c = 0; c < kMlaQBoxes; ++c)
              tma_load_3d(smem + L::q + (st * kMlaQBoxes + c) * kMlaBox, &map_q, full + st,
                          c * kD, q0, bh);
            for (int c = 0; c < kMlaVBoxes; ++c)
              tma_load_3d(smem + L::dout + (st * kMlaVBoxes + c) * kMlaBox, &map_do, full + st,
                          c * kD, q0, bh);
          }
          float* sl = stats + st * 2 * kBlock;
#pragma unroll
          for (int r = lane; r < kBlock; r += 32) {
            const int qrow = q0 + r;
            const bool in = qrow < t;
            sl[r] = in ? fmaxf(lse_h[qrow], kDeadClamp) : 0.f;
            sl[kBlock + r] = in ? delta_h[qrow] : 0.f;
          }
          mbar_arrive(full + st);  // releases this lane's lse / delta stores
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<232>();
    if (wg == 1)
      mla_bwd_consumer<0>(smem, &map_dq, stats, kv_full, kv_empty, full, empty, pad, pair_q,
                          pair_flags, pair_bits, dk, dv, pr, bh, n0, n1, heads, t, scale_s,
                          scale_dq);
    else
      mla_bwd_consumer<1>(smem, &map_dq, stats, kv_full, kv_empty, full, empty, pad, pair_q,
                          pair_flags, pair_bits, dk, dv, pr, bh, n0, n1, heads, t, scale_s,
                          scale_dq);
  }
}

// Encodes the tensor maps and launches on `stream`: q, k [bh, t, 192] and
// v, dout [bh, t, 128] bf16, dq_acc [bh, t, 192] fp32; the rest as
// launch_bwd_kv's.
cudaError_t launch_bwd_mla(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, const void* pad,
                           const void* pair_ptr, const void* pair_q, const void* pair_flags,
                           const void* pair_bits, const void* pair_order, void* dq_acc, void* dk,
                           void* dv, int bh, int heads, int t, int n_pairs, float scale_s,
                           float scale_dq, void* stream) {
  CUtensorMap maps[5];
  const void* bases[4] = {q, k, v, dout};
  const int widths[4] = {kMlaDqk, kMlaDqk, kMlaDv, kMlaDv};
  const uint32_t box[3] = {kD, kBlock, 1};
  for (int i = 0; i < 4; ++i) {
    const uint64_t dims[3] = {uint64_t(widths[i]), uint64_t(t), uint64_t(bh)};
    const uint64_t strides[2] = {uint64_t(widths[i]) * 2, uint64_t(t) * widths[i] * 2};
    if (!make_map(&maps[i], bases[i], 3, dims, strides, box)) return cudaErrorInvalidValue;
  }
  const uint64_t dq_dims[3] = {uint64_t(kMlaDqk), uint64_t(t), uint64_t(bh)};
  const uint64_t dq_strides[2] = {uint64_t(kMlaDqk) * 4, uint64_t(t) * kMlaDqk * 4};
  const uint32_t dq_box[3] = {32, kBlock, 1};
  if (!make_map(&maps[4], dq_acc, 3, dq_dims, dq_strides, dq_box,
                CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return cudaErrorInvalidValue;
  constexpr uint32_t smem = MlaSmem::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_mla_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, n_pairs);
  flash_bwd_mla_kernel<<<grid, kMlaThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(pad),
      static_cast<const int*>(pair_ptr), static_cast<const int*>(pair_q),
      static_cast<const int*>(pair_flags), static_cast<const uint64_t*>(pair_bits),
      static_cast<const int*>(pair_order), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, t, scale_s, scale_dq);
  return cudaSuccess;
}

}  // namespace
