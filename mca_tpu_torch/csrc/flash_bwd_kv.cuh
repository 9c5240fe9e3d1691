// The kv-major flash-attention backward for Hopper (sm_90a): TMA, wgmma,
// warp specialisation.  Shared by K2 (flash_bwd.cu: dk, dv and dq in one
// pass) and K3b (flash_bwd_dkv.cu: dk and dv only).  What it computes,
// exactly as the TPU kernels _fused_bwd_kernel and _dkv_kernel
// (mca_tpu/ops/flash_attention.py) do:
//
//   q_s = bf16(q * bf16(scale))
//   s   = q_s k^T in fp32, blocked entries -> p = 0
//   p   = exp(s - max(lse, DEAD_CLAMP))        (fp32; dead rows give 0)
//   dv += bf16(p)^T do                         (fp32 accumulation)
//   dp  = do v^T                               (fp32)
//   ds  = p * (dp - delta)                     (delta = rowsum(do * out))
//   dk += bf16(ds)^T q_s
//   dq += scale * bf16(ds) k                   (K2 only)
//
// The kernel reads q as the wrapper hands it and multiplies s and dk by
// `scale_s` in fp32: either q_s itself and 1, or, where bf16(scale) is a
// power of two (the model's 64^-0.5 = 2^-3), q and bf16(scale), which
// gives the same s and dk bit for bit (ops/flash_attention.py
// _q_operand).
//
// Design.  A block owns one (b, h) and a PAIR of 64-key kv tiles (2j,
// 2j + 1), and walks the pair's row of kv_pair_schedule (the union of the
// two tiles' columns of the kv-major tile schedule, with a live and a
// full flag per half and, for a tile that is not full, its mask
// transposed as 64 rows of 64 bits: row = key, bit c = query c blocked).
// Three warpgroups:
//   - the producer: one warp TMA-loads the pair's k and v tiles once
//     (both, also a second tile past T, which reads as zeros), then each
//     item's q and do tiles (3-D maps [B*H, T, 64], rows past T read as
//     zero) through a 3-stage mbarrier ring; its lanes put the item's lse
//     (floored at DEAD_CLAMP) and delta beside them;
//   - two consumer warpgroups, one per kv tile of the pair, sharing every
//     q / do stage.  Each keeps dk and dv as fp32 wgmma accumulators for
//     the whole walk, and per item issues s^T = k q_s^T and dp^T = v do^T
//     (all four operands K-major in shared memory), turns s^T into p^T in
//     place (mask bits and key padding, lse), adds dv += p^T do (p^T as
//     the register A operand, do read MN-major through the descriptor's
//     transpose bit), turns dp^T into ds^T, adds dk += ds^T q_s the same
//     way, and, for K2, computes this tile's dq partial ds k: ds^T goes
//     to shared memory in bf16 (A MN-major, transpose bit) against k's
//     tile (B MN-major), and the fp32 partial, times the scale, is added
//     into the [B*H, T, 64] fp32 buffer by one TMA reduce-add per
//     32-column half (a 128-byte swizzled fp32 map: rows past T are not
//     written), through two staging buffers so that a reduce reads one
//     while the next item fills the other.  The two consumers reduce
//     their partials separately; the order of the additions changes from
//     run to run (K3a is the deterministic route).
//   - The loop body is straight-line, so that ptxas keeps the wgmma
//     pipeline: an item where a consumer's tile is not live (8% of the
//     half-items on the TCGA mask) is computed with every entry blocked,
//     which adds exactly 0 to dk and dv, and only its dq reduce is left
//     out.  So each consumer also waits for and releases every item of
//     its pair in order (a parity wait cannot tell phase r of a stage
//     from r + 2).
//
// Key padding and the ragged edge are per key (a key's row of s^T is all
// blocked or not), read once per block; the query side of the ragged
// edge is in the mask bits (the tile is then never full).  dk and dv of
// a padded key come out exactly 0.
//
// Blocks start longest walk first (kv_pair_order): with every head of a
// pair started together, the last wave holds the shortest walks.
//
// Measured (chip_smoke.py phase 4, TCGA_config1, NVIDIA H100 80GB HBM3,
// 700.00 W): K2 0.4398 ms a layer (the mma.sync version before it
// 1.4223; SDPA's backward 1.4200 in the same run), K3b 0.2981 (1.0454).
// Summing the two consumers' dq partials in shared memory before one
// reduce (a 256-thread barrier an item) ran level with a reduce per
// consumer; starting the longest walks first gained 3-4% (K2) and 4-6%
// (K3b).  SASS: K2 20 HGMMA with 3 waits, 6 UTMALDG, 2 UTMAREDG; K3b 16
// HGMMA; 168 registers at launch, no spills, no wgmma serialisation.

#pragma once

#include "flash_tile.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int kBwdStages = 3;        // q / do ring depth
constexpr int kBwdThreads = 384;     // producer + two consumer warpgroups
constexpr uint32_t kBwdTile = kBlock * kD * 2;   // one 64 x 64 bf16 tile, 8 KB
constexpr uint32_t kDqHalf = kBlock * 32 * 4;    // 64 rows x 32 fp32, 8 KB

// shared memory, from a 1024-byte aligned base: k and v tiles of the
// pair, the q / do ring, with dq one ds^T tile and two staging buffers of
// two halves per consumer, the lse / delta ring, the mbarriers
template <bool kWithDq>
struct BwdKvSmem {
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + 2 * kBwdTile;
  static constexpr uint32_t q = v + 2 * kBwdTile;
  static constexpr uint32_t dout = q + kBwdStages * kBwdTile;
  static constexpr uint32_t ds = dout + kBwdStages * kBwdTile;
  static constexpr uint32_t dq = ds + (kWithDq ? 2 * kBwdTile : 0);
  static constexpr uint32_t stats = dq + (kWithDq ? 2 * 2 * 2 * kDqHalf : 0);
  static constexpr uint32_t bars = stats + kBwdStages * 2 * kBlock * 4;
  static constexpr uint32_t bytes = bars + (1 + 2 * kBwdStages) * 8 + 1024;
};

template <bool kWithDq>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_kv_kernel(const __grid_constant__ CUtensorMap map_q,
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
  using L = BwdKvSmem<kWithDq>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kBwdStages;
  float* stats = reinterpret_cast<float*>(smem + L::stats);  // per stage: lse[64], delta[64]

  // blocks start in the order of blockIdx (x fastest): every head of the
  // longest walk first, the shortest last, so the tail wave is short
  const int pr = pair_order[blockIdx.y], bh = blockIdx.x;
  const int n0 = pair_ptr[pr], n1 = pair_ptr[pr + 1];
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + s, 32);  // the producer warp's lanes
      mbar_init(empty + s, 8);  // one arrival per consumer warp
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
      if (lane == 0) {
        // both tiles, also a second one past t (TMA reads it as zeros)
        mbar_expect_tx(kv_full, 4 * kBwdTile);
        tma_load_3d(smem + L::k, &map_k, kv_full, 0, 2 * pr * kBlock, bh);
        tma_load_3d(smem + L::v, &map_v, kv_full, 0, 2 * pr * kBlock, bh);
        tma_load_3d(smem + L::k + kBwdTile, &map_k, kv_full, 0, (2 * pr + 1) * kBlock, bh);
        tma_load_3d(smem + L::v + kBwdTile, &map_v, kv_full, 0, (2 * pr + 1) * kBlock, bh);
      }
      const float* lse_h = lse + size_t(bh) * t;
      const float* delta_h = delta + size_t(bh) * t;
      for (int n = n0; n < n1; ++n) {
        const int it = n - n0, st = it % kBwdStages;
        mbar_wait(empty + st, ((it / kBwdStages) & 1) ^ 1);
        const int q0 = pair_q[n] * kBlock;
        if (lane == 0) {
          mbar_expect_tx_only(full + st, 2 * kBwdTile);
          tma_load_3d(smem + L::q + st * kBwdTile, &map_q, full + st, 0, q0, bh);
          tma_load_3d(smem + L::dout + st * kBwdTile, &map_do, full + st, 0, q0, bh);
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
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<232>();
    const int h = wg - 1;                  // kv tile 2 pr + h
    const int tid = threadIdx.x % 128;
    const int wl = tid / 32, lane = tid % 32;
    const int g = lane >> 2, c2 = 2 * (lane & 3);
    const int r0 = 16 * wl + g;            // this thread's rows: r0, r0 + 8
    const int k0 = (2 * pr + h) * kBlock;
    const size_t head_off = size_t(bh) * t * kD;
    const uint32_t q_a = smem_u32(smem + L::q), do_a = smem_u32(smem + L::dout);
    const uint32_t k_a = smem_u32(smem + L::k + h * kBwdTile);
    const uint32_t v_a = smem_u32(smem + L::v + h * kBwdTile);
    const uint32_t ds_a = smem_u32(smem + L::ds + h * kBwdTile);
    const uint32_t dq_a = smem_u32(smem + L::dq + h * 2 * 2 * kDqHalf);

    // keys r0 and r0 + 8: past t or padded blocks the whole row of s^T
    const uint8_t* pad_b = pad ? pad + size_t(bh / heads) * t : nullptr;
    bool keyblk[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = k0 + r0 + 8 * hh;
      keyblk[hh] = j >= t || (pad_b != nullptr && pad_b[j] != 0);
    }

    float dk_acc[32], dv_acc[32], s[32], dp[32];
    uint32_t pa[kBlock / 16][4], dsa[kBlock / 16][4];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_full, 0);

    // The loop body is straight-line: an item where this tile is not
    // live is computed all the same, with every entry blocked (p = 0, so
    // ds = 0 and it adds exactly nothing), and only its dq reduce is
    // left out.
    for (int n = n0; n < n1; ++n) {
      const int it = n - n0, st = it % kBwdStages;
      const int fl = pair_flags[n];
      const bool live = (fl >> h) & 1;
      uint64_t rb[2] = {~uint64_t(0), ~uint64_t(0)};
      if (live) {
        rb[0] = rb[1] = 0;
        if (!((fl >> (2 + h)) & 1)) {
          const uint64_t* bits = pair_bits + (size_t(n) * 2 + h) * kBlock;
          rb[0] = bits[r0];
          rb[1] = bits[r0 + 8];
        }
      }
      if (keyblk[0]) rb[0] = ~uint64_t(0);
      if (keyblk[1]) rb[1] = ~uint64_t(0);
      const float* sl = stats + st * 2 * kBlock;
      const uint32_t qb = q_a + st * kBwdTile, dob = do_a + st * kBwdTile;
      mbar_wait(full + st, (it / kBwdStages) & 1);

      // s^T = k q_s^T and dp^T = v do^T: rows = keys, columns = queries;
      // all four operands K-major in shared memory
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(s, wgmma_desc(k_a + 32 * kk), wgmma_desc(qb + 32 * kk), kk != 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_m64n64k16_ss(dp, wgmma_desc(v_a + 32 * kk), wgmma_desc(dob + 32 * kk), kk != 0);
      wgmma_commit();

      // p^T in place, blocked entries 0, then p^T in bf16 as the A
      // fragments of dv += p^T do (the accumulators of query blocks 2j
      // and 2j + 1 are the A fragment of the j-th 16-query step)
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb) {
        const float2 l2 = *reinterpret_cast<const float2*>(sl + 8 * nb + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * nb + c2 + (e & 1);
          const bool blocked = (rb[e >> 1] >> c) & 1;
          const float x = (s[4 * nb + e] * scale_s - ((e & 1) ? l2.y : l2.x)) * kLog2e;
          s[4 * nb + e] = blocked ? 0.f : exp2f(x);
        }
      }
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j) {
        pa[j][0] = pack_bf16x2(s[8 * j + 0], s[8 * j + 1]);
        pa[j][1] = pack_bf16x2(s[8 * j + 2], s[8 * j + 3]);
        pa[j][2] = pack_bf16x2(s[8 * j + 4], s[8 * j + 5]);
        pa[j][3] = pack_bf16x2(s[8 * j + 6], s[8 * j + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j)
        wgmma_m64n64k16_rs<1>(dv_acc, pa[j], wgmma_desc(dob + 2048 * j), 1);
      wgmma_commit();

      // ds^T = p^T (dp^T - delta) in place of dp^T, then in bf16 as the A
      // fragments of dk += ds^T q_s (and, for dq, in shared memory)
      wgmma_wait<1>();
      fence_regs(dp);
#pragma unroll
      for (int nb = 0; nb < kBlock / 8; ++nb) {
        const float2 d2 = *reinterpret_cast<const float2*>(sl + kBlock + 8 * nb + c2);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * nb + e] = s[4 * nb + e] * (dp[4 * nb + e] - ((e & 1) ? d2.y : d2.x));
      }
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j) {
        dsa[j][0] = pack_bf16x2(dp[8 * j + 0], dp[8 * j + 1]);
        dsa[j][1] = pack_bf16x2(dp[8 * j + 2], dp[8 * j + 3]);
        dsa[j][2] = pack_bf16x2(dp[8 * j + 4], dp[8 * j + 5]);
        dsa[j][3] = pack_bf16x2(dp[8 * j + 6], dp[8 * j + 7]);
      }
      if constexpr (kWithDq) {
        // ds^T as [key][query] bf16 rows (the same registers as dsa)
#pragma unroll
        for (int j = 0; j < kBlock / 16; ++j) {
          st_shared_u32(ds_a + swz128(r0, 16 * j + c2), dsa[j][0]);
          st_shared_u32(ds_a + swz128(r0 + 8, 16 * j + c2), dsa[j][1]);
          st_shared_u32(ds_a + swz128(r0, 16 * j + 8 + c2), dsa[j][2]);
          st_shared_u32(ds_a + swz128(r0 + 8, 16 * j + 8 + c2), dsa[j][3]);
        }
        fence_async_smem();
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kBlock / 16; ++j)
        wgmma_m64n64k16_rs<1>(dk_acc, dsa[j], wgmma_desc(qb + 2048 * j), 1);
      wgmma_commit();
      if constexpr (kWithDq) {
        // dq partial = ds k: rows = queries; A = ds^T read MN-major, B =
        // k's tile read MN-major, 16 keys a step
        named_barrier(1 + h, 128);  // every warp's ds^T rows are stored
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBlock / 16; ++j)
          wgmma_m64n64k16_ss<1, 1>(s, wgmma_desc(ds_a + 2048 * j), wgmma_desc(k_a + 2048 * j),
                                   j != 0);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      if (lane == 0) mbar_arrive(empty + st);  // q, do, lse, delta read

      if constexpr (kWithDq) {
        // the partial, times the scale, into the staging buffer of this
        // item's parity (two 32-column halves, 128-byte swizzle); one
        // thread adds it into dq_acc, for live items only (the others'
        // partials are 0)
        fence_regs(s);
        const uint32_t buf = dq_a + (it & 1) * 2 * kDqHalf;
#pragma unroll
        for (int nb = 0; nb < kD / 8; ++nb) {
          const uint32_t half = buf + (nb / 4) * kDqHalf;
          const int col = 8 * (nb % 4) + c2;
          st_shared_f32x2(half + swz128_f32(r0, col), scale_dq * s[4 * nb],
                          scale_dq * s[4 * nb + 1]);
          st_shared_f32x2(half + swz128_f32(r0 + 8, col), scale_dq * s[4 * nb + 2],
                          scale_dq * s[4 * nb + 3]);
        }
        fence_async_smem();
        // every reduce issued so far has read its buffer, so the next
        // item may fill the other one
        if (tid == 0) bulk_wait_read<0>();
        named_barrier(1 + h, 128);
        if (tid == 0 && live) {
          const int q0 = pair_q[n] * kBlock;
          tma_reduce_add_3d(&map_dq, buf, 0, q0, bh);
          tma_reduce_add_3d(&map_dq, buf + kDqHalf, 32, q0, bh);
          bulk_commit();
        }
      }
    }
    if constexpr (kWithDq) {
      if (tid == 0) bulk_wait<0>();
    }

    // dk (times scale_s) and dv of this thread's keys, once, as bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = k0 + r0 + 8 * hh;
      if (key >= t) continue;
      __nv_bfloat16* dkrow = dk + head_off + size_t(key) * kD;
      __nv_bfloat16* dvrow = dv + head_off + size_t(key) * kD;
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        *reinterpret_cast<uint32_t*>(dkrow + 8 * nb + c2) = pack_bf16x2(
            scale_s * dk_acc[4 * nb + 2 * hh], scale_s * dk_acc[4 * nb + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(dvrow + 8 * nb + c2) =
            pack_bf16x2(dv_acc[4 * nb + 2 * hh], dv_acc[4 * nb + 2 * hh + 1]);
      }
    }
  }
}

// Encodes the tensor maps and launches the template on `stream`.  q, k,
// v, dout: [bh, t, 64] bf16; dq_acc: [bh, t, 64] fp32 or null (K3b); the
// rest as mca_flash_bwd's arguments.  Returns cudaErrorInvalidValue when
// cuTensorMapEncodeTiled refuses a map, the error of setting the shared
// memory size, or cudaSuccess once the launch is issued (the caller
// checks cudaGetLastError()).
template <bool kWithDq>
cudaError_t launch_bwd_kv(const void* q, const void* k, const void* v, const void* dout,
                          const void* lse, const void* delta, const void* pad,
                          const void* pair_ptr, const void* pair_q, const void* pair_flags,
                          const void* pair_bits, const void* pair_order, void* dq_acc, void* dk,
                          void* dv, int bh, int heads, int t, int n_pairs, float scale_s,
                          float scale_dq, void* stream) {
  CUtensorMap maps[5];
  const void* bases[4] = {q, k, v, dout};
  const uint64_t dims[3] = {uint64_t(kD), uint64_t(t), uint64_t(bh)};
  const uint64_t strides[2] = {kD * 2, uint64_t(t) * kD * 2};
  const uint32_t box[3] = {kD, kBlock, 1};
  for (int i = 0; i < 4; ++i)
    if (!make_map(&maps[i], bases[i], 3, dims, strides, box)) return cudaErrorInvalidValue;
  if (kWithDq) {
    const uint64_t dq_strides[2] = {kD * 4, uint64_t(t) * kD * 4};
    const uint32_t dq_box[3] = {32, kBlock, 1};
    if (!make_map(&maps[4], dq_acc, 3, dims, dq_strides, dq_box,
                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return cudaErrorInvalidValue;
  } else {
    maps[4] = maps[0];  // not read
  }
  constexpr uint32_t smem = BwdKvSmem<kWithDq>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kv_kernel<kWithDq>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, n_pairs);
  flash_bwd_kv_kernel<kWithDq><<<grid, kBwdThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const uint8_t*>(pad),
      static_cast<const int*>(pair_ptr), static_cast<const int*>(pair_q),
      static_cast<const int*>(pair_flags), static_cast<const uint64_t*>(pair_bits),
      static_cast<const int*>(pair_order), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, t, scale_s, scale_dq);
  return cudaSuccess;
}

}  // namespace
