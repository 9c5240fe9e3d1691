// Block-sparse masked flash attention, backward dk / dv (K3b), for
// Hopper (sm_90a): TMA, wgmma, warp specialisation.
//
// Replaces the TPU kernel mca_tpu/ops/flash_attention.py::_dkv_kernel
// (the second pl.pallas_call of make_flash_attention's split _bwd_call):
// the kv-major half of the split backward.  The kernel body and its
// design are flash_bwd_kv.cuh's without dq; K3a (flash_bwd_dq.cu)
// computes dq.
//
// Bound on this card: four products of depth 64 per live score entry
// (s, dp, dv, dk); at TCGA_config1 ~4.7e10 FLOP per layer, 47 us at 989
// TFLOP/s bf16, against ~126 MB of q, k, v, do read and dk, dv written
// (38 us at 3.35 TB/s): operations-bound, like K2.  Measured: 0.2981 ms a
// layer, 6.3x the bound (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).

#include "flash_bwd_kv.cuh"

extern "C" const char* mca_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// As mca_flash_bwd without dq_acc and scale_dq.  Launches on `stream`,
// does not synchronise, returns cudaGetLastError() (or
// cudaErrorInvalidValue when a tensor map is refused).
extern "C" int mca_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, const void* pad,
                                 const void* pair_ptr, const void* pair_q, const void* pair_flags,
                                 const void* pair_bits, const void* pair_order, void* dk,
                                 void* dv, int bh, int heads, int t, int n_pairs, float scale_s,
                                 void* stream) {
  const cudaError_t err =
      launch_bwd_kv<false>(q, k, v, dout, lse, delta, pad, pair_ptr, pair_q, pair_flags,
                           pair_bits, pair_order, nullptr, dk, dv, bh, heads, t, n_pairs,
                           scale_s, 1.f, stream);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}
