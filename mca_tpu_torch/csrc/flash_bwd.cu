// Block-sparse masked flash attention, fused backward (K2), for Hopper
// (sm_90a): TMA, wgmma, warp specialisation, and the dq partials added
// by TMA reduce-add.
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::
// _fused_bwd_kernel (launched through pl.pallas_call in
// make_flash_attention's _bwd_call_fused): one kv-major pass that
// recomputes s and p from lse and produces dq, dk and dv together.  The
// kernel body, what it computes and its design are flash_bwd_kv.cuh's,
// with dq.
//
// Inputs: q (or q_s, see flash_bwd_kv.cuh), k, v, do [B*H, T, 64] bf16;
// lse and delta [B*H, T] fp32; the [B, T] key padding as uint8 (1 =
// padded); the static mask as kv_pair_schedule.  Outputs: dk, dv [B*H,
// T, 64] bf16 and dq added into a zeroed fp32 [B*H, T, 64] buffer.
//
// Bound on this card: the backward does five products of depth 64 per
// live score entry (s, dp, dv, dk, dq) against the forward's two.  At
// TCGA_config1 (B 8, H 8, T 2548) that is ~5.8e10 FLOP per layer for
// ~9e7 live entries, 59 us at 989 TFLOP/s bf16, while q, k, v, do in and
// dq, dk, dv out are ~147 MB, 44 us at 3.35 TB/s: operations-bound.
// chip_smoke.py computes both for its inputs.  The kernel does the
// products on whole 64 x 64 tiles (a tile's blocked entries cost as
// much as its live ones, and a pair item's idle half as much as a live
// one: 1.77x the bound's work on the TCGA mask) and adds each live
// tile's 16 KB fp32 dq partial into device memory.  Measured: 0.4398 ms
// a layer, 7.4x the bound (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).

#include "flash_bwd_kv.cuh"

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, dout, dk, dv: [bh, t, 64] bf16; dq_acc: [bh, t, 64] fp32,
// zeroed by the caller; lse, delta: [bh, t] fp32; pad: [bh / heads, t]
// uint8 or null; pair_ptr: [n_pairs + 1] int32; pair_q, pair_flags:
// [pair_ptr[n_pairs]] int32; pair_bits: [pair_ptr[n_pairs], 2, 64]
// uint64 (ops/flash_attention.py kv_pair_schedule); pair_order:
// [n_pairs] int32, the pairs longest walk first (kv_pair_order).  s and
// dk are multiplied by scale_s, dq by scale_dq.  Encodes the tensor maps,
// launches on `stream`, does not synchronise, returns cudaGetLastError()
// (or cudaErrorInvalidValue when cuTensorMapEncodeTiled refuses a map).
extern "C" int mca_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* pad,
                             const void* pair_ptr, const void* pair_q, const void* pair_flags,
                             const void* pair_bits, const void* pair_order, void* dq_acc,
                             void* dk, void* dv, int bh, int heads, int t, int n_pairs,
                             float scale_s, float scale_dq, void* stream) {
  const cudaError_t err =
      launch_bwd_kv<true>(q, k, v, dout, lse, delta, pad, pair_ptr, pair_q, pair_flags,
                          pair_bits, pair_order, dq_acc, dk, dv, bh, heads, t, n_pairs, scale_s,
                          scale_dq, stream);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
