// The flash-attention kernels' tile geometry and softmax constants, and
// the quad reductions over a row of an mma accumulator (a row's entries
// sit in the 4 lanes of a quad, in mma.sync's m16n8 layout and in each
// warp's slice of a wgmma accumulator alike).  Shared by the Hopper
// kernels (K1 in flash_fwd.cu, K2 / K3b in flash_bwd_kv.cuh) and, through
// flash_common.cuh, by the mma.sync ones.

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
