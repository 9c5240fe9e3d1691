// Block-sparse masked flash attention, fused backward (K2), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::
// _fused_bwd_kernel (launched through pl.pallas_call in
// make_flash_attention's _bwd_call_fused): one kv-major pass that
// recomputes s and p from lse and produces dq, dk and dv together.  The
// kernel body, and what it computes, is flash_bwd_kv.cuh's, with dq.
//
// Inputs: q, k, v, do [B*H, T, 64] bf16; lse and delta [B*H, T] fp32;
// the static [T, T] mask and the [B, T] key padding as uint8 (1 =
// blocked); the kv-major CSR schedule.  Outputs: dk, dv [B*H, T, 64]
// bf16 and dq added into a zeroed fp32 [B*H, T, 64] buffer.
//
// Bound on this card: the backward does five products of depth 64 per
// live score entry (s, dp, dv, dk, dq) against the forward's two.  At
// TCGA_config1 (B 8, H 8, T 2548) that is ~5.8e10 FLOP per layer for
// ~9e7 live entries, 59 us at 989 TFLOP/s bf16, while q, k, v, do in and
// dq, dk, dv out are ~147 MB, 44 us at 3.35 TB/s: operations-bound.
// chip_smoke.py computes both for its inputs.  This version issues
// mma.sync (not wgmma), stages tiles through shared memory with plain
// loads, and adds dq with one fp32 atomic per element per visited tile;
// wgmma, TMA and a cheaper dq reduction are later work.

#include "flash_bwd_kv.cuh"

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q, k, v, dout, dk, dv: [bh, t, 64] bf16; dq_acc: [bh, t, 64] fp32,
// zeroed by the caller; lse, delta: [bh, t] fp32; mask: [t, t] uint8;
// pad: [bh / heads, t] uint8 or null; col_ptr: [n_kblocks + 1] int32;
// row_idx, full: [col_ptr[n_kblocks]] int32.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
extern "C" int mca_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* mask,
                             const void* pad, const void* col_ptr, const void* row_idx,
                             const void* full, void* dq_acc, void* dk, void* dv, int bh,
                             int heads, int t, int n_kblocks, float scale_q, float scale,
                             void* stream) {
  constexpr size_t smem = bwd_kv_smem_bytes<true>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kv_kernel<true>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_kblocks, bh);
  flash_bwd_kv_kernel<true><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(pad),
      static_cast<const int*>(col_ptr), static_cast<const int*>(row_idx),
      static_cast<const int*>(full), static_cast<float*>(dq_acc),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), heads, t, scale_q,
      scale);
  return int(cudaGetLastError());
}
