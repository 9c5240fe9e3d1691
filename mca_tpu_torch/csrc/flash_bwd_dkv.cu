// Block-sparse masked flash attention, backward dk / dv (K3b), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::_dkv_kernel
// (the second pl.pallas_call of make_flash_attention's split _bwd_call):
// the kv-major half of the split backward.  The kernel body is
// flash_bwd_kv.cuh's without dq; K3a (flash_bwd_dq.cu) computes dq.
//
// Bound on this card: four products of depth 64 per live score entry
// (s, dp, dv, dk); at TCGA_config1 ~4.7e10 FLOP per layer, 47 us at 989
// TFLOP/s bf16, against ~126 MB of q, k, v, do read and dk, dv written
// (38 us at 3.35 TB/s): operations-bound, like K2.  The same mma.sync
// design as K2; wgmma and TMA are later work.

#include "flash_bwd_kv.cuh"

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// As mca_flash_bwd without dq_acc.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
extern "C" int mca_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* mask,
                                 const void* pad, const void* col_ptr, const void* row_idx,
                                 const void* full, void* dk, void* dv, int bh, int heads, int t,
                                 int n_kblocks, float scale_q, void* stream) {
  constexpr size_t smem = bwd_kv_smem_bytes<false>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kv_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(n_kblocks, bh);
  flash_bwd_kv_kernel<false><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const uint8_t*>(mask), static_cast<const uint8_t*>(pad),
      static_cast<const int*>(col_ptr), static_cast<const int*>(row_idx),
      static_cast<const int*>(full), nullptr, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, t, scale_q, 1.f);
  return int(cudaGetLastError());
}
