// The flash-attention kernels' tile geometry and softmax constants, and
// the quad reductions over a row of an mma accumulator (a row's entries
// sit in the 4 lanes of a quad, in mma.sync's m16n8 layout and in each
// warp's slice of a wgmma accumulator alike).  Shared by the flash
// kernels (K1 flash_fwd.cu, K3a flash_bwd_dq.cu, K2 / K3b
// flash_bwd_kv.cuh), the roofline counter (K6), the overlap probe (K7)
// and, through flash_common.cuh, its control (K8).

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kD = 64;         // head dim (compile-time)
constexpr int kBlock = 64;     // q rows and kv columns per tile
constexpr float kNegInf = -1e30f;
constexpr float kDeadClamp = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace
