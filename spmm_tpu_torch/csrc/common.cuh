// Shared device helpers of the hand-written kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spmm_tpu_torch {

// dtype codes passed by the Python wrappers (kernels.F32, kernels.BF16)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

}  // namespace spmm_tpu_torch
