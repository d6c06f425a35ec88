// K3: the gradient of K2 (csrc/ell_slab_spmm.cu) with respect to the slab
// values, for every slab of a list in ONE launch -- a sampled dense-dense
// product over the slabs' slots:
//   dData_s[r, e] = sum_{j < k} dY[row0_s + r, j] * B[clamp(cols_s[r, e], 0, n-1), j]
// Padding slots (data 0, column clipped) get what the formula gives, as the
// JAX package's gradient of its gather + sum does.
//
// No TPU counterpart: the JAX package has no backward kernel (its gradients
// are XLA's transposes of the gathers and sums of spmm_tpu/ops/ell_spmm.py:
// _slab_loop, :37-51, and of the Pallas kernel's XLA twin).  Here the forward
// is a hand-written kernel that autograd cannot see through, so its value
// gradient is one too.
//
// What bounds it on this card: bytes, as K2.  Each slot reads one B row of k
// values for 2k FLOP and writes one value; the dY row is read once per row.
// The least traffic is the slots' columns and outputs, the distinct B rows
// and the dY rows -- the same bytes as K2 at the same k.
//
// Design (simple and exact in its order; not tuned):
// - It walks K2's own device slab table and work items (ops/ell_kernel.py:
//   work_table), so the rows run in the same L2-friendly order: a group of
//   TPR lanes per row (a warp at k = 128), the CTA's groups on consecutive
//   rows of one slab, or -- for rows longer than the split threshold -- the
//   entries of one row cut over the CTA's groups.
// - The lane's VEC columns of the dY row stay in registers (for k beyond
//   TPR * VEC the further columns are re-read through L1); per batch of 4
//   entries every lane starts 4 independent B-row loads (ld.global.nc),
//   multiplies, and the group adds its lanes by __shfl_xor_sync in a fixed
//   order -- no atomics, the same bits on every run.  Lane j of the group
//   writes the batch's entry j.

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kSlabFields = 6;  // int64 per slab: cols, data, L, R, row0, chunk
constexpr int kUnroll = 4;      // B-row loads in flight per lane

template <typename TB, typename TA, int VEC, int TPR>
__global__ void __launch_bounds__(kThreads)
ell_slabs_sddmm_kernel(const long long* __restrict__ slabs, const int2* __restrict__ items,
                       const long long* __restrict__ slot0, const TA* __restrict__ dY,
                       const TB* __restrict__ B, TA* __restrict__ out, long long n, long long k) {
  const int2 it = items[blockIdx.x];
  const long long* sl = slabs + static_cast<long long>(kSlabFields) * it.x;
  const int* cols = reinterpret_cast<const int*>(sl[0]);
  const int L = static_cast<int>(sl[2]);
  const long long R = sl[3];
  const TA* ybase = dY + sl[4] * k;
  const int chunk = static_cast<int>(sl[5]);  // > 0: one row cut over the groups
  TA* obase = out + slot0[it.x];

  const int g = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const long long units = k / VEC;

  // this group's row and entries [e_lo, e_end), walked in n_e steps; n_e is
  // the same for the whole CTA, so every shuffle below runs on full warps
  long long r;
  int e_lo, e_end, n_e;
  if (chunk > 0) {
    r = it.y;
    e_lo = g * chunk;
    e_end = min(L, e_lo + chunk);
    n_e = chunk;
  } else {
    r = it.y + g;
    e_lo = 0;
    e_end = r < R ? L : 0;
    n_e = L;
  }
  const bool live = e_end > e_lo;
  const int* rc = cols + r * L;  // dereferenced only for e < e_end
  const TA* yrow = ybase + r * k;
  TA* orow = obase + r * L;

  TA y0[VEC];  // the dY row's columns lane * VEC .. + VEC
#pragma unroll
  for (int q = 0; q < VEC; ++q) y0[q] = 0;
  if (live && lane < units) ldg_vec<VEC>(yrow + static_cast<long long>(lane) * VEC, y0);

  for (int e0 = 0; e0 < n_e; e0 += kUnroll) {
    long long c[kUnroll];
    bool ok[kUnroll];
    TA s[kUnroll];
#pragma unroll
    for (int jj = 0; jj < kUnroll; ++jj) {
      const int e = e_lo + e0 + jj;
      ok[jj] = e < e_end;
      long long cc = ok[jj] ? rc[e] : 0;
      c[jj] = cc < 0 ? 0 : (cc >= n ? n - 1 : cc);
      s[jj] = 0;
    }
    for (long long u0 = 0; u0 < units; u0 += TPR) {
      const long long u = u0 + lane;
      const bool ucol = u < units;
      TA yv[VEC];
      if (u0 == 0) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) yv[q] = y0[q];
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) yv[q] = 0;
        if (live && ucol) ldg_vec<VEC>(yrow + u * VEC, yv);
      }
      TA bv[kUnroll][VEC];
#pragma unroll
      for (int jj = 0; jj < kUnroll; ++jj) {
        if (ok[jj] && ucol) {
          ldg_vec<VEC>(B + c[jj] * k + u * VEC, bv[jj]);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) bv[jj][q] = 0;
        }
      }
#pragma unroll
      for (int jj = 0; jj < kUnroll; ++jj) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) s[jj] = mad(yv[q], bv[jj][q], s[jj]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < kUnroll; ++jj) {
#pragma unroll
      for (int off = TPR / 2; off > 0; off >>= 1) {
        s[jj] += __shfl_xor_sync(0xffffffffu, s[jj], off, TPR);
      }
      if (ok[jj] && lane == jj % TPR) orow[e_lo + e0 + jj] = s[jj];
    }
  }
}

// VECW: the wide lane layout of the type (4 columns, 2 in fp64); vec is it or 1
template <typename TB, typename TA, int VECW>
cudaError_t launch(const long long* slabs, const int2* items, unsigned n_items,
                   const long long* slot0, const void* dY, const void* B, void* out, long long n,
                   long long k, int vec, int tpr_log2, cudaStream_t s) {
  const TA* y = static_cast<const TA*>(dY);
  const TB* b = static_cast<const TB*>(B);
  TA* o = static_cast<TA*>(out);
#define SPMM_TPU_TORCH_K3(V, T)                                                              \
  ell_slabs_sddmm_kernel<TB, TA, V, T><<<n_items, kThreads, 0, s>>>(slabs, items, slot0, y, b, \
                                                                    o, n, k)
#define SPMM_TPU_TORCH_K3_TPR(V)                  \
  switch (tpr_log2) {                             \
    case 0: SPMM_TPU_TORCH_K3(V, 1); break;       \
    case 1: SPMM_TPU_TORCH_K3(V, 2); break;       \
    case 2: SPMM_TPU_TORCH_K3(V, 4); break;       \
    case 3: SPMM_TPU_TORCH_K3(V, 8); break;       \
    case 4: SPMM_TPU_TORCH_K3(V, 16); break;      \
    case 5: SPMM_TPU_TORCH_K3(V, 32); break;      \
    default: return cudaErrorInvalidValue;        \
  }
  if (vec == VECW) {
    SPMM_TPU_TORCH_K3_TPR(VECW)
  } else if (vec == 1) {
    SPMM_TPU_TORCH_K3_TPR(1)
  } else {
    return cudaErrorInvalidValue;
  }
#undef SPMM_TPU_TORCH_K3_TPR
#undef SPMM_TPU_TORCH_K3
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmm_tpu_torch

// slabs, items: K2's device tables (ops/ell_kernel.py: work_table); slot0
// (S,) int64: the offset of slab s in the flat output.  dY (rows, k) and out
// are fp32 for an fp32 or bf16 B and fp64 for an fp64 B.
extern "C" int ell_slabs_sddmm_launch(const void* slabs, const void* items, long long n_items,
                                      const void* slot0, const void* dY, const void* B,
                                      int b_dtype, void* out, long long n, long long k, int vec,
                                      int tpr_log2, void* stream) {
  using namespace spmm_tpu_torch;
  if (n_items <= 0) return 0;
  if (n < 1 || k < 1 || n_items > 0x7fffffff || vec < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && (k % vec != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(dY) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* sl = static_cast<const long long*>(slabs);
  const int2* it = static_cast<const int2*>(items);
  const long long* s0 = static_cast<const long long*>(slot0);
  const unsigned ni = static_cast<unsigned>(n_items);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b_dtype == kF32)
    err = launch<float, float, 4>(sl, it, ni, s0, dY, B, out, n, k, vec, tpr_log2, s);
  else if (b_dtype == kBF16)
    err = launch<__nv_bfloat16, float, 4>(sl, it, ni, s0, dY, B, out, n, k, vec, tpr_log2, s);
  else if (b_dtype == kF64)
    err = launch<double, double, 2>(sl, it, ni, s0, dY, B, out, n, k, vec, tpr_log2, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
