// K2: a list of uniform-width ELL slabs times a dense matrix on Hopper, in
// ONE launch.  Slab s is (R_s, L_s); its rows land at rows row0_s .. row0_s +
// R_s of one output:
//   out[row0_s + r, :] = sum_{e < L_s} data_s[r, e] * B[clamp(cols_s[r, e], 0, n-1), :]
// accumulated in fp32 (fp32 or bf16 data and B) or in fp64 (fp64 data and B:
// the card has native fp64 units, so fp64 products run on this kernel too).
//
// Replaces the Pallas TPU kernel spmm_tpu/ops/pallas_ell.py:
// ell_slab_octets_pallas (pl.pallas_call at :89, body _octet_kernel at
// :39-79), reached by ell_slab_spmm_pallas (:102-123, which clamps the
// columns to [0, n-1] at :121).  On the TPU that kernel fetched B rows by one
// DMA each, was limited to k == 128, R % 8 == 0 and an SMEM-sized index
// stream, and was never dispatched; the same per-slab sums ran as XLA gathers
// in ell_spmm._slab_loop (ell_spmm.py:37-51).  Here it is the slab product
// under ell_spmm / ell_spmv, every bucket of blocked_spmm_slab and the device
// CSR's ELL pack, for any R, any L >= 1 and any k >= 1.
//
// What bounds it on this card: it is a gather.  Each (row, e) reads one B row
// of k values and does 2k FLOP with it -- 0.5 FLOP/byte in fp32 -- so the
// bound is bytes: the distinct B rows read plus cols/data plus the output
// (0.28 ms at k = 128 over the web-Google-sized ELL pack at 3.35 TB/s).  What
// kept the first design (one launch per slab, one warp walking its row's L
// entries in sequence) at ~10% of that bound was latency: every step was a
// dependent pair of loads (column id, then B row), 78 launches ran one after
// another, and a slab of a few long rows occupied a few warps of the card for
// L such steps.
//
// Design:
// - One launch per product over a work table built once per pack on the host
//   (ops/ell_kernel.py: work_table): per slab its cols/data pointers, L, R,
//   output row offset and how its rows are cut; per CTA one work item (slab,
//   first row).
// - A row's k columns go to a group of TPR adjacent lanes (the smallest power
//   of two covering k / VEC column units, a warp at k = 128); each lane owns
//   VEC = 4 adjacent columns (one 16-byte fp32 / 8-byte bf16 load; 2 columns
//   in fp64, the same 16 bytes) when k % VEC == 0 and the pointers are
//   16-byte aligned, else VEC = 1 (any k).
// - Loads in flight: the group loads its next TPR (col, data) pairs with one
//   coalesced load per lane, clamps them, and hands them out by __shfl_sync;
//   every lane then issues kUnroll (4-8) independent B-row loads through the
//   read-only path (ld.global.nc) before their FMAs.  The output is written
//   with streaming stores (st.global.cs) so that it does not push hot B rows
//   out of the 50 MB L2.
// - Order: the items run in the order of their rows in the original matrix
//   (or the packed format's final order), not slab by slab: neighbouring
//   rows of a graph share columns, so the CTAs in flight share B rows
//   through L2 (the largest single gain of the redesign; the repo's
//   sweep_k2.py).
// - Short rows (L <= the split threshold): one row per group, the CTA's
//   groups on consecutive rows of one slab.  Long rows: one row per CTA, its
//   L entries cut into chunks over the CTA's groups; the partial sums meet in
//   shared memory and are added in group order -- no atomics, the same
//   result on every run.
// - Two optional maps, a template parameter (MAP) so that the product
//   without them is the kernel above, load for load:
//   - out_rows[slab row] (MAP >= 1): the output row the slab row is written
//     to, in place of row0_s + r.  ell_spmm writes each row of A at its
//     original row with it (no un-permute gather after the launch, and none
//     of its atomic backward), and the transposed product writes each row
//     of A^T at its own row, the pieces of cut rows at scratch rows;
//   - vidx[slot] (MAP == 2): the slab's value pointer in the table points at
//     int32 indices into one flat value array (vals), -1 reading zero.  The
//     transposed pack reads A's values through it where they are stored,
//     instead of a gather of every value into its own layout per call.

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kSlabFields = 6;  // int64 per slab: cols, data, L, R, row0, chunk

template <typename TD, typename TB, typename TA, int VEC, int TPR, int MAP>
__global__ void __launch_bounds__(kThreads)
ell_slabs_kernel(const long long* __restrict__ slabs, const int2* __restrict__ items,
                 const TB* __restrict__ B, TA* __restrict__ out, long long n, long long k,
                 const int* __restrict__ out_rows, const TD* __restrict__ vals) {
  // independent B-row loads in flight per lane: 4 at 16-32 lanes a row (2-4
  // KB of B rows per warp) and at one lane a row (k = 1), 8 at 2-8 lanes --
  // the fastest of 2, 4, 8 and 16 at each lane layout in the repo's
  // sweep_k2.py on the H100 (PERF.md), which builds its variants with
  // -DSPMM_K2_UNROLL=n
#ifdef SPMM_K2_UNROLL
  constexpr int kUnroll = SPMM_K2_UNROLL;
#else
  constexpr int kUnroll = TPR >= 16 || TPR == 1 ? 4 : 8;
#endif
  constexpr int kPairs = kUnroll > TPR ? kUnroll / TPR : 1;  // (col, data) registers per lane
  constexpr int kBatch = kPairs * TPR;                       // entries handed out per batch
  __shared__ TA part[kThreads * VEC];                        // a split row's partial sums

  const int2 it = items[blockIdx.x];
  const long long* sl = slabs + static_cast<long long>(kSlabFields) * it.x;
  const int* cols = reinterpret_cast<const int*>(sl[0]);
  const TD* data = reinterpret_cast<const TD*>(sl[1]);  // MAP == 2: int32 indices into vals
  const int L = static_cast<int>(sl[2]);
  const long long R = sl[3];
  const int chunk = static_cast<int>(sl[5]);  // > 0: one row cut over the groups

  const int g = threadIdx.x / TPR;
  const int lane = threadIdx.x % TPR;
  const long long units = k / VEC;

  // this group's row and entries [e_lo, e_end), walked in n_e steps; n_e is
  // the same for the whole CTA, so every __shfl_sync below runs on full warps
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
  const int* rc = cols + r * L;  // dereferenced only for e < e_end
  const TD* rd = data + r * L;
  const int* rv = reinterpret_cast<const int*>(sl[1]) + r * L;
  // the row this group writes (read only for a row of the slab)
  long long orow = sl[4] + r;
  if constexpr (MAP >= 1) orow = r < R ? out_rows[sl[4] + r] : 0;
  TA* orow_p = out + orow * k;

  for (long long u0 = 0; u0 < units; u0 += TPR) {
    const long long u = u0 + lane;
    const bool ucol = u < units;
    const TB* bcol = B + u * VEC;
    TA acc[VEC];
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[q] = 0;

    for (int e0 = 0; e0 < n_e; e0 += kBatch) {
      int mc[kPairs];
      TA ma[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const int e = e_lo + e0 + p * TPR + lane;
        mc[p] = 0;
        ma[p] = 0;
        if (e < e_end) {
          const long long c = rc[e];
          mc[p] = static_cast<int>(c < 0 ? 0 : (c >= n ? n - 1 : c));
          if constexpr (MAP == 2) {
            const int vi = rv[e];
            ma[p] = vi >= 0 ? to_acc<TA>(vals[vi]) : TA(0);
          } else {
            ma[p] = to_acc<TA>(rd[e]);
          }
        }
      }
#pragma unroll
      for (int j0 = 0; j0 < kBatch; j0 += kUnroll) {
        if (e0 + j0 >= n_e) break;
        TA av[kUnroll];
        TA bv[kUnroll][VEC];
#pragma unroll
        for (int jj = 0; jj < kUnroll; ++jj) {
          const int j = j0 + jj;
          int c = mc[j / TPR];
          TA a = ma[j / TPR];
          if constexpr (TPR > 1) {
            c = __shfl_sync(0xffffffffu, c, j % TPR, TPR);
            a = __shfl_sync(0xffffffffu, a, j % TPR, TPR);
          }
          av[jj] = a;
          if (ucol && e_lo + e0 + j < e_end) {
            ldg_vec<VEC>(bcol + static_cast<long long>(c) * k, bv[jj]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) bv[jj][q] = 0;
          }
        }
#pragma unroll
        for (int jj = 0; jj < kUnroll; ++jj) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) acc[q] = mad(av[jj], bv[jj][q], acc[q]);
        }
      }
    }

    if (chunk == 0) {
      if (r < R && ucol) {
        stcs_vec<VEC>(orow_p + u * VEC, acc);
      }
    } else {
      // part[g][lane * VEC + q]; the first TPR * VEC threads add the
      // groups that hold entries, in group order
#pragma unroll
      for (int q = 0; q < VEC; ++q) part[threadIdx.x * VEC + q] = acc[q];
      __syncthreads();
      const int t = threadIdx.x;
      const long long col = u0 * VEC + t;
      if (t < TPR * VEC && col < k) {
        const int used = (L + chunk - 1) / chunk;
        TA s = 0;
        for (int gg = 0; gg < used; ++gg) s += part[gg * TPR * VEC + t];
        orow_p[col] = s;
      }
      __syncthreads();
    }
  }
}

template <typename TD, typename TB, typename TA, int VECW, int MAP>
cudaError_t launch_map(const long long* slabs, const int2* items, unsigned n_items, const TB* b,
                       TA* o, long long n, long long k, int vec, int tpr_log2, const int* out_rows,
                       const TD* v, cudaStream_t s) {
#define SPMM_TPU_TORCH_K2(V, T)                                                            \
  ell_slabs_kernel<TD, TB, TA, V, T, MAP><<<n_items, kThreads, 0, s>>>(slabs, items, b, o, n, k, \
                                                                      out_rows, v)
#define SPMM_TPU_TORCH_K2_TPR(V)                  \
  switch (tpr_log2) {                             \
    case 0: SPMM_TPU_TORCH_K2(V, 1); break;       \
    case 1: SPMM_TPU_TORCH_K2(V, 2); break;       \
    case 2: SPMM_TPU_TORCH_K2(V, 4); break;       \
    case 3: SPMM_TPU_TORCH_K2(V, 8); break;       \
    case 4: SPMM_TPU_TORCH_K2(V, 16); break;      \
    case 5: SPMM_TPU_TORCH_K2(V, 32); break;      \
    default: return cudaErrorInvalidValue;        \
  }
  if (vec == VECW) {
    SPMM_TPU_TORCH_K2_TPR(VECW)
  } else if (vec == 1) {
    SPMM_TPU_TORCH_K2_TPR(1)
  } else {
    return cudaErrorInvalidValue;
  }
#undef SPMM_TPU_TORCH_K2_TPR
#undef SPMM_TPU_TORCH_K2
  return cudaGetLastError();
}

// VECW: the wide lane layout of the type (4 columns, 2 in fp64); vec is it or
// 1.  MAXMAP: the largest map this type pair is built with (2 only for the
// transposed product's pairs, whose B is the fp32 / fp64 gradient)
template <typename TD, typename TB, typename TA, int VECW, int MAXMAP>
cudaError_t launch(const long long* slabs, const int2* items, unsigned n_items, const void* B,
                   void* out, long long n, long long k, int vec, int tpr_log2, int map,
                   const int* out_rows, const void* vals, cudaStream_t s) {
  const TB* b = static_cast<const TB*>(B);
  TA* o = static_cast<TA*>(out);
  const TD* v = static_cast<const TD*>(vals);
#define SPMM_TPU_TORCH_K2_MAP(M) \
  launch_map<TD, TB, TA, VECW, M>(slabs, items, n_items, b, o, n, k, vec, tpr_log2, out_rows, v, s)
  if (map == 0) return SPMM_TPU_TORCH_K2_MAP(0);
  if (map == 1) return SPMM_TPU_TORCH_K2_MAP(1);
  if constexpr (MAXMAP == 2) {
    if (map == 2) return SPMM_TPU_TORCH_K2_MAP(2);
  }
#undef SPMM_TPU_TORCH_K2_MAP
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace spmm_tpu_torch

// slabs: (S, 6) int64 device table; items: (n_items, 2) int32 device table
// (ops/ell_kernel.py: work_table).  vec and tpr_log2 are the lane layout the
// table was cut for.  out is fp32 for fp32 / bf16 operands and fp64 for fp64
// data times fp64 B; no other mix is built.  out_rows (int32, one per slab
// row, or null): the output row of each slab row.  vals (or null; needs
// out_rows): the flat values the table's value pointers index (int32, -1
// for zero), of data_dtype; built for fp32 or bf16 values with an fp32 B and
// for fp64 with fp64.
extern "C" int ell_slabs_spmm_launch(const void* slabs, const void* items, long long n_items,
                                     int data_dtype, const void* B, int b_dtype, void* out,
                                     long long n, long long k, int vec, int tpr_log2,
                                     const void* out_rows, const void* vals, void* stream) {
  using namespace spmm_tpu_torch;
  if (n_items <= 0 || k <= 0) return 0;
  if (n < 1 || n_items > 0x7fffffff || vec < 1 || (vals && !out_rows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && (k % vec != 0 || reinterpret_cast<uintptr_t>(B) % 16 != 0 ||
                  reinterpret_cast<uintptr_t>(out) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* sl = static_cast<const long long*>(slabs);
  const int2* it = static_cast<const int2*>(items);
  const unsigned ni = static_cast<unsigned>(n_items);
  const int* rows = static_cast<const int*>(out_rows);
  const int map = vals ? 2 : (out_rows ? 1 : 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SPMM_TPU_TORCH_K2_CALL(TD, TB, TA, VECW, MAXMAP) \
  launch<TD, TB, TA, VECW, MAXMAP>(sl, it, ni, B, out, n, k, vec, tpr_log2, map, rows, vals, s)
  if (data_dtype == kF32 && b_dtype == kF32)
    err = SPMM_TPU_TORCH_K2_CALL(float, float, float, 4, 2);
  else if (data_dtype == kF32 && b_dtype == kBF16)
    err = SPMM_TPU_TORCH_K2_CALL(float, __nv_bfloat16, float, 4, 1);
  else if (data_dtype == kBF16 && b_dtype == kF32)
    err = SPMM_TPU_TORCH_K2_CALL(__nv_bfloat16, float, float, 4, 2);
  else if (data_dtype == kBF16 && b_dtype == kBF16)
    err = SPMM_TPU_TORCH_K2_CALL(__nv_bfloat16, __nv_bfloat16, float, 4, 1);
  else if (data_dtype == kF64 && b_dtype == kF64)
    err = SPMM_TPU_TORCH_K2_CALL(double, double, double, 2, 2);
  else
    err = cudaErrorInvalidValue;
#undef SPMM_TPU_TORCH_K2_CALL
  return static_cast<int>(err);
}
