// Ordered segment sum: out[s, :] = sum over positions i in [offsets[s],
// offsets[s+1]) of data[row(i), :], row(i) = order[i] (or i itself when the
// ids were sorted), summed in an order fixed by the shapes alone -- the
// same bits on every run.
//
// No TPU kernel: it replaces the XLA segment sums of the JAX package
// (jax.ops.segment_sum, e.g. spmm_tpu/ops/spmm.py: spmm_xla), which the port
// first wrote as torch's index_add_ -- atomic adds on CUDA, whose order, and
// so whose rounding, changes from run to run (ROADMAP F6).
//
// What bounds it on this card: bytes.  Each data row is read once and each
// output row written once (one add per element read).  What would keep it
// from that is a segment far longer than the rest: a web graph's hub rows
// (75 rows of PageRank's leftover stream hold 1.37M rows at k = 1), which
// one thread walking its column in order would take serially.
//
// Design (simple, exact in its order; not tuned):
// - One CTA of 256 threads per (segment, column tile).  A row's k columns
//   go to CT adjacent lanes (the smallest power of two covering k / VEC
//   units, at most 256), each lane VEC adjacent columns (one 16-byte load
//   when k % VEC == 0 and data is aligned), and the 256 / CT lane groups
//   split the segment's rows: group g takes rows g, g + G, g + 2G, ... -- at
//   k = 1 that is 256 rows in flight, at k = 128 fp32 eight.
// - Each lane sums its rows in order (four loads in flight, added in row
//   order), the groups' partial sums meet in shared memory and lane group 0
//   adds them in group order.  Empty segments write zeros.

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // row loads in flight per lane

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

template <typename T, int VEC, bool ORDER>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ data, const long long* __restrict__ offsets,
                   const long long* __restrict__ order, T* __restrict__ out, long long k,
                   int ct_log2) {
  __shared__ Vec<T, VEC> part[kThreads];
  const int ct = 1 << ct_log2;
  const int groups = kThreads >> ct_log2;
  const int g = threadIdx.x >> ct_log2;
  const long long u = static_cast<long long>(blockIdx.y) * ct + (threadIdx.x & (ct - 1));
  const long long units = k / VEC;
  const long long s = blockIdx.x;
  const long long lo = offsets[s], hi = offsets[s + 1];

  Vec<T, VEC> acc;
#pragma unroll
  for (int q = 0; q < VEC; ++q) acc.v[q] = 0;
  if (u < units) {
    const T* col = data + u * VEC;
    auto row_of = [&](long long i) -> long long { return ORDER ? order[i] : i; };
    long long i = lo + g;
    for (; i + (kUnroll - 1) * groups < hi; i += kUnroll * groups) {
      Vec<T, VEC> v[kUnroll];
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
        v[j] = *reinterpret_cast<const Vec<T, VEC>*>(col + row_of(i + j * groups) * k);
#pragma unroll
      for (int j = 0; j < kUnroll; ++j)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc.v[q] += v[j].v[q];
    }
    for (; i < hi; i += groups) {
      const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(col + row_of(i) * k);
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc.v[q] += v.v[q];
    }
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (g == 0 && u < units) {
    Vec<T, VEC> sum = part[threadIdx.x];
    for (int gg = 1; gg < groups; ++gg) {
      const Vec<T, VEC> p = part[gg * ct + threadIdx.x];
#pragma unroll
      for (int q = 0; q < VEC; ++q) sum.v[q] += p.v[q];
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + s * k + u * VEC) = sum;
  }
}

// VECW: the 16-byte vector of the type; vec is it or 1
template <typename T, int VECW>
cudaError_t launch(const void* data, const long long* offsets, const long long* order, void* out,
                   long long nseg, long long k, int vec, int ct_log2, cudaStream_t s) {
  const long long units = k / vec;
  const long long tiles = (units + (1LL << ct_log2) - 1) >> ct_log2;
  if (tiles > 65535 || nseg > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(nseg), static_cast<unsigned>(tiles));
  const T* d = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
#define SPMM_TPU_TORCH_SEG(V)                                                              \
  if (order)                                                                                \
    segment_sum_kernel<T, V, true><<<grid, kThreads, 0, s>>>(d, offsets, order, o, k, ct_log2); \
  else                                                                                      \
    segment_sum_kernel<T, V, false><<<grid, kThreads, 0, s>>>(d, offsets, order, o, k, ct_log2)
  if (vec == VECW) {
    SPMM_TPU_TORCH_SEG(VECW);
  } else if (vec == 1) {
    SPMM_TPU_TORCH_SEG(1);
  } else {
    return cudaErrorInvalidValue;
  }
#undef SPMM_TPU_TORCH_SEG
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmm_tpu_torch

// data (N, k) and out (nseg, k) of one dtype (float32, float64, int32, int64),
// contiguous; offsets (nseg + 1,) int64 sorted; order (N,) int64 or null.
// vec: 16 / sizeof(dtype) when k % vec == 0 and data, out are 16-byte aligned,
// else 1; ct_log2: log2 of the lanes that share one row (at most 8).
extern "C" int segment_sum_launch(const void* data, const void* offsets, const void* order,
                                  void* out, int dtype, long long nseg, long long k, int vec,
                                  int ct_log2, void* stream) {
  using namespace spmm_tpu_torch;
  if (nseg <= 0 || k <= 0) return 0;
  if (ct_log2 < 0 || ct_log2 > 8 || vec < 1 || k % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && (reinterpret_cast<uintptr_t>(data) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* off = static_cast<const long long*>(offsets);
  const long long* ord = static_cast<const long long*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float, 4>(data, off, ord, out, nseg, k, vec, ct_log2, s);
  else if (dtype == kF64)
    err = launch<double, 2>(data, off, ord, out, nseg, k, vec, ct_log2, s);
  else if (dtype == kI32)
    err = launch<int, 4>(data, off, ord, out, nseg, k, vec, ct_log2, s);
  else if (dtype == kI64)
    err = launch<long long, 2>(data, off, ord, out, nseg, k, vec, ct_log2, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
