// K2: one uniform-width ELL slab times a dense matrix on Hopper,
//   out[r, :] = sum_{e < L} data[r, e] * B[clamp(cols[r, e], 0, n-1), :]
// for r < R, accumulated in fp32 in order of e.
//
// Replaces the Pallas TPU kernel spmm_tpu/ops/pallas_ell.py:
// ell_slab_octets_pallas (pl.pallas_call at :89, body _octet_kernel at
// :39-79), reached by ell_slab_spmm_pallas (:102-123, which clamps the
// columns to [0, n-1] at :121).  On the TPU that kernel fetched B rows by one
// DMA each, was limited to k == 128, R % 8 == 0 and an SMEM-sized index
// stream, and was never dispatched; the same per-slab sum ran as XLA gathers
// in ell_spmm._slab_loop (ell_spmm.py:37-51).  Here it is the slab product
// under ell_spmm for any R, any L >= 1 and any k >= 1.
//
// What bounds it on this card: it is a gather.  Each (row, e) reads one B row
// of k values and does 2k FLOP with them -- 0.5 FLOP/byte in fp32 -- so the
// kernel is bound by the bytes of B rows it gathers (hits in the 50 MB L2 for
// popular columns, HBM otherwise) and by the latency of those dependent
// loads; arithmetic is irrelevant.
//
// Design: rows are spread over threads, and a row's k columns over a group of
// `tpr` adjacent lanes (tpr = min(32, units), a power of two, one warp per
// row at k = 128).  Each lane owns VEC = 4 adjacent columns and loads them
// with one 16-byte (fp32) or 8-byte (bf16) load when k % 4 == 0 and the
// pointers are 16-byte aligned; otherwise VEC = 1 with scalar loads, which
// covers any k.  So the lanes of a row read a B row as one contiguous
// segment, and every lane of the group reads the same cols/data entry
// (broadcast).  Sums stay in registers, in order of e, with no atomics; the
// result is written once, straight into the caller's rows of the sorted
// output buffer (saving the per-slab concatenation of ell_spmm.py:57).

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename TD, typename TB, int VEC>
__global__ void __launch_bounds__(kThreads)
ell_slab_spmm_kernel(const int* __restrict__ cols, const TD* __restrict__ data,
                     const TB* __restrict__ B, float* __restrict__ out, int64_t R, int L,
                     int64_t n, int64_t k, int tpr_log2) {
  const int tpr = 1 << tpr_log2;
  const int lane = threadIdx.x & (tpr - 1);
  const int64_t r = static_cast<int64_t>(blockIdx.x) * (kThreads >> tpr_log2) +
                    (threadIdx.x >> tpr_log2);
  if (r >= R) return;
  const int* rc = cols + r * L;
  const TD* rd = data + r * L;
  float* orow = out + r * k;
  const int64_t units = k / VEC;
  for (int64_t u = lane; u < units; u += tpr) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    const TB* bcol = B + u * VEC;
    for (int e = 0; e < L; ++e) {
      int64_t c = rc[e];
      c = c < 0 ? 0 : (c >= n ? n - 1 : c);
      const float a = to_f32(rd[e]);
      float bv[VEC];
      if constexpr (VEC == 4) {
        load4(bcol + c * k, bv);
      } else {
        bv[0] = to_f32(bcol[c * k]);
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(a, bv[i], acc[i]);
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(orow + u * 4) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      orow[u] = acc[0];
    }
  }
}

template <typename TD, typename TB>
cudaError_t launch(const int* cols, const void* data, const void* B, float* out, int64_t R,
                   int L, int64_t n, int64_t k, cudaStream_t s) {
  const bool aligned = (reinterpret_cast<uintptr_t>(B) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int vec = (k % 4 == 0 && aligned) ? 4 : 1;
  const int64_t units = k / vec;
  int tpr_log2 = 0;
  while ((int64_t{1} << tpr_log2) < units && tpr_log2 < 5) ++tpr_log2;
  const int64_t rows_per_block = kThreads >> tpr_log2;
  const int64_t blocks = (R + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  const TD* d = static_cast<const TD*>(data);
  const TB* b = static_cast<const TB*>(B);
  if (vec == 4)
    ell_slab_spmm_kernel<TD, TB, 4><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        cols, d, b, out, R, L, n, k, tpr_log2);
  else
    ell_slab_spmm_kernel<TD, TB, 1><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        cols, d, b, out, R, L, n, k, tpr_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmm_tpu_torch

extern "C" int ell_slab_spmm_launch(const void* cols, const void* data, int data_dtype,
                                    const void* B, int b_dtype, void* out, long long R, int L,
                                    long long n, long long k, void* stream) {
  using namespace spmm_tpu_torch;
  if (R <= 0 || k <= 0) return 0;
  if (L < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* c = static_cast<const int*>(cols);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (data_dtype == kF32 && b_dtype == kF32)
    err = launch<float, float>(c, data, B, o, R, L, n, k, s);
  else if (data_dtype == kF32 && b_dtype == kBF16)
    err = launch<float, __nv_bfloat16>(c, data, B, o, R, L, n, k, s);
  else if (data_dtype == kBF16 && b_dtype == kF32)
    err = launch<__nv_bfloat16, float>(c, data, B, o, R, L, n, k, s);
  else if (data_dtype == kBF16 && b_dtype == kBF16)
    err = launch<__nv_bfloat16, __nv_bfloat16>(c, data, B, o, R, L, n, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
