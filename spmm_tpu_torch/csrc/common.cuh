// Shared device helpers of the hand-written kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace spmm_tpu_torch {

// dtype codes passed by the Python wrappers (kernels.F32, kernels.BF16,
// kernels.F64, kernels.I32, kernels.I64)
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
constexpr int kF64 = 2;
constexpr int kI32 = 3;
constexpr int kI64 = 4;

// a stored value widened to the accumulate type TA (float or double)
template <typename TA> __device__ __forceinline__ TA to_acc(float x) { return static_cast<TA>(x); }
template <typename TA> __device__ __forceinline__ TA to_acc(double x) { return static_cast<TA>(x); }
template <typename TA> __device__ __forceinline__ TA to_acc(__nv_bfloat16 x) {
  return static_cast<TA>(__bfloat162float(x));
}

__device__ __forceinline__ float mad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double mad(double a, double b, double c) { return fma(a, b, c); }

// VEC adjacent values through the read-only path (ld.global.nc), widened to
// the accumulate type: one 16-byte load for 4 floats or 2 doubles, one 8-byte
// load for 4 bf16, one scalar load at VEC = 1
template <int VEC>
__device__ __forceinline__ void ldg_vec(const float* p, float* v) {
  if constexpr (VEC == 4) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
    static_assert(VEC == 1, "fp32 loads are 4 wide or scalar");
    v[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void ldg_vec(const __nv_bfloat16* p, float* v) {
  if constexpr (VEC == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else {
    static_assert(VEC == 1, "bf16 loads are 4 wide or scalar");
    v[0] = __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
  }
}

template <int VEC>
__device__ __forceinline__ void ldg_vec(const double* p, double* v) {
  if constexpr (VEC == 2) {
    const double2 d = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = d.x; v[1] = d.y;
  } else {
    static_assert(VEC == 1, "fp64 loads are 2 wide or scalar");
    v[0] = __ldg(p);
  }
}

// VEC adjacent sums as one streaming store (st.global.cs)
template <int VEC>
__device__ __forceinline__ void stcs_vec(float* o, const float* a) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(o), make_float4(a[0], a[1], a[2], a[3]));
  } else {
    __stcs(o, a[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void stcs_vec(double* o, const double* a) {
  if constexpr (VEC == 2) {
    __stcs(reinterpret_cast<double2*>(o), make_double2(a[0], a[1]));
  } else {
    __stcs(o, a[0]);
  }
}

}  // namespace spmm_tpu_torch
