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
// and the dY rows -- the same bytes as K2 at the same k (947.1 MB, 0.2827 ms
// at k = 128 over the web-Google-sized pack at 3.35 TB/s).  What kept the
// first design (a lane group per slab ROW, 4 entries a batch, one 5-level
// shuffle chain per entry, one lane storing 4 bytes per entry) from it: on
// rows of ~6 slots a warp had at most L B-row loads in flight, and each batch
// paid the column load, the B loads and the shuffle chain in series.
//
// Design: slot-major.
// - The work table is K3's own (ops/ell_kernel.py: sddmm_table, memoized
//   beside K2's): per CTA (slab, first slot), each of its 8 warps a run of
//   consecutive slots (slot = r * L + e) of one slab, walked in steps of 32 *
//   U slots.  A row of any length is cut at those steps, so long rows need no
//   split; the items run in the order of their rows in the original matrix,
//   as K2's, so that CTAs in flight share B rows through L2.
// - A row's k columns go to a group of TPR lanes (a warp at k = 128), each
//   lane VEC adjacent columns (16-byte loads).  In a step, group gi of a warp
//   takes the slots u * 32 + gi * TPR + [0, TPR) (U = 8 / TPR units when TPR <
//   8), in sub-batches of 8 slots per lane: the lane issues the 8 B-row loads
//   (ld.global.nc) and the dY rows' loads -- a dY row only where the slot's
//   row differs from the previous slot's (through K2's row map when ROWMAP)
//   -- before any FMA, and keeps one partial dot product per slot.
// - A transpose-reduction in place of one shuffle chain per slot: at each
//   level a lane sends the half of its partials that its partner keeps, so 8
//   slots over 32 lanes take 4 + 2 + 1 shuffles and 2 more to join the lanes
//   left (per 32 slots 40, against 32 x 5 before), and the sum of slot j
//   lands in lane j: the warp writes 32 consecutive slots with one coalesced
//   store.  Below 8 lanes a row, the same over the TPR-lane group (TPR - 1
//   shuffles for TPR slots).
// - Overlap: the next step's columns and dY row indices are loaded before the
//   current step's sub-batches are reduced.
// - No atomics: every slot is written by one lane, its sum taken in an order
//   fixed by k alone -- the same bits on every run.

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kSlabFields = 6;  // int64 per slab: cols, data (unused), L, R, row0, chunk (unused)
constexpr int kSub = 8;         // slots per lane in flight (a sub-batch)
constexpr int kSteps = 4;       // steps per warp (ops/ell_kernel.py: K3_STEPS)
constexpr unsigned kFull = 0xffffffffu;

// v[0 .. NS) of each of the TPR lanes of a group, summed over the group: after
// it lane t holds the sum of slot t >> log2(TPR / NS) (replicated over TPR / NS
// lanes).  Each level halves the values: a lane keeps the half its bit of the
// offset names and adds its partner's copy of it.
template <int NS, int TPR, typename TA>
__device__ __forceinline__ TA transpose_reduce(TA* v, int tl) {
#pragma unroll
  for (int h = NS / 2, o = TPR / 2; h >= 1; h >>= 1, o >>= 1) {
    const bool up = tl & o;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const TA send = up ? v[i] : v[i + h];
      const TA keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, o, TPR);
    }
  }
  TA s = v[0];
#pragma unroll
  for (int o = TPR / NS / 2; o >= 1; o >>= 1) s += __shfl_xor_sync(kFull, s, o, TPR);
  return s;
}

template <typename TB, typename TA, int VEC, int TPR, bool ROWMAP>
__global__ void __launch_bounds__(kThreads)
ell_slabs_sddmm_kernel(const long long* __restrict__ slabs, const int2* __restrict__ items,
                       const long long* __restrict__ slot0, const TA* __restrict__ dY,
                       const TB* __restrict__ B, TA* __restrict__ out, long long n, long long k,
                       const int* __restrict__ out_rows) {
  constexpr int NS = TPR >= kSub ? kSub : TPR;   // slots per reduce unit
  constexpr int U = TPR >= kSub ? 1 : kSub / TPR;  // units per sub-batch
  constexpr int NSB = TPR >= kSub ? TPR / kSub : 1;  // sub-batches per step
  constexpr int STEP = 32 * U;                    // slots per warp step
  constexpr int WSLOTS = STEP * kSteps;           // slots per warp

  const int2 it = items[blockIdx.x];
  const long long* sl = slabs + static_cast<long long>(kSlabFields) * it.x;
  const int* cols = reinterpret_cast<const int*>(sl[0]);
  const int L = static_cast<int>(sl[2]);
  const long long nslots = sl[3] * L;
  const long long row0 = sl[4];
  TA* obase = out + slot0[it.x];

  const int lane = threadIdx.x & 31;
  const int gi = lane / TPR, tl = lane % TPR;
  const long long w0 = it.y + static_cast<long long>(threadIdx.x >> 5) * WSLOTS;
  const long long w1 = min(w0 + WSLOTS, nslots);
  if (w0 >= w1) return;  // whole warps only: no block-wide barrier below
  const long long units = k / VEC;

  // this lane's slots q + u * 32 + lane of a step: clamped column and dY row
  // (-1 past the run)
  auto load_step = [&](long long q, int* cw, int* yw) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long slot = q + u * 32 + lane;
      if (slot < w1) {
        const int cc = cols[slot];
        cw[u] = cc < 0 ? 0 : (cc >= n ? static_cast<int>(n - 1) : cc);
        const long long r = slot / L;
        yw[u] = ROWMAP ? out_rows[row0 + r] : static_cast<int>(row0 + r);
      } else {
        cw[u] = 0;
        yw[u] = -1;
      }
    }
  };

  int cw[U], yw[U];
  load_step(w0, cw, yw);
  for (long long q0 = w0; q0 < w1; q0 += STEP) {
    int cn[U], yn[U];
    if (q0 + STEP < w1) load_step(q0 + STEP, cn, yn);  // the next step's indices, in flight now
    TA outv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) outv[u] = 0;
#pragma unroll
    for (int sb = 0; sb < NSB; ++sb) {
      // the sub-batch's slots j = u * NS + t: lane gi * TPR + sb * NS + t of unit u
      int cj[kSub], yj[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int src = gi * TPR + sb * NS + j % NS;
        cj[j] = __shfl_sync(kFull, cw[j / NS], src);
        yj[j] = __shfl_sync(kFull, yw[j / NS], src);
      }
      TA part[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) part[j] = 0;
      for (long long u0 = 0; u0 < units; u0 += TPR) {
        const long long u = u0 + tl;
        const bool ucol = u < units;
        TA bv[kSub][VEC], yv[kSub][VEC];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const bool fresh = j == 0 || yj[j] != yj[j - 1];
          if (ucol && yj[j] >= 0) {
            ldg_vec<VEC>(B + static_cast<long long>(cj[j]) * k + u * VEC, bv[j]);
            if (fresh) ldg_vec<VEC>(dY + static_cast<long long>(yj[j]) * k + u * VEC, yv[j]);
          } else {
#pragma unroll
            for (int q = 0; q < VEC; ++q) bv[j][q] = yv[j][q] = 0;
          }
        }
        TA y[VEC];
#pragma unroll
        for (int j = 0; j < kSub; ++j) {
          const bool fresh = j == 0 || yj[j] != yj[j - 1];
#pragma unroll
          for (int q = 0; q < VEC; ++q) {
            if (fresh) y[q] = yv[j][q];
            part[j] = mad(y[q], bv[j][q], part[j]);
          }
        }
      }
      if constexpr (TPR >= kSub) {
        const TA s = transpose_reduce<NS, TPR>(part, tl);
        // slot sb * 8 + jj sits in the lanes jj << log2(TPR / 8): lane t of
        // the group takes slot t when t / 8 == sb
        const TA got = TPR == kSub ? s : __shfl_sync(kFull, s, (tl % kSub) * (TPR / kSub), TPR);
        if (tl / kSub == sb) outv[0] = got;
      } else {
#pragma unroll
        for (int u = 0; u < U; ++u) outv[u] = transpose_reduce<NS, TPR>(part + u * NS, tl);
      }
    }
    // lane t of the warp holds slot q0 + u * 32 + t: coalesced stores
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long slot = q0 + u * 32 + lane;
      if (slot < w1) obase[slot] = outv[u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cw[u] = cn[u];
      yw[u] = yn[u];
    }
  }
}

// VECW: the wide lane layout of the type (4 columns, 2 in fp64); vec is it or 1
template <typename TB, typename TA, int VECW, bool ROWMAP>
cudaError_t launch_map(const long long* slabs, const int2* items, unsigned n_items,
                       const long long* slot0, const void* dY, const void* B, void* out,
                       long long n, long long k, int vec, int tpr_log2, const int* out_rows,
                       cudaStream_t s) {
  const TA* y = static_cast<const TA*>(dY);
  const TB* b = static_cast<const TB*>(B);
  TA* o = static_cast<TA*>(out);
#define SPMM_TPU_TORCH_K3(V, T)                                                   \
  ell_slabs_sddmm_kernel<TB, TA, V, T, ROWMAP><<<n_items, kThreads, 0, s>>>(        \
      slabs, items, slot0, y, b, o, n, k, out_rows)
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

template <typename TB, typename TA, int VECW>
cudaError_t launch(const long long* slabs, const int2* items, unsigned n_items,
                   const long long* slot0, const void* dY, const void* B, void* out, long long n,
                   long long k, int vec, int tpr_log2, const int* out_rows, cudaStream_t s) {
  if (out_rows)
    return launch_map<TB, TA, VECW, true>(slabs, items, n_items, slot0, dY, B, out, n, k, vec,
                                          tpr_log2, out_rows, s);
  return launch_map<TB, TA, VECW, false>(slabs, items, n_items, slot0, dY, B, out, n, k, vec,
                                         tpr_log2, out_rows, s);
}

}  // namespace
}  // namespace spmm_tpu_torch

// slabs: the (S, 6) int64 slab table (cols pointer, -, L, R, row0, -); items
// (n_items, 2) int32: K3's work items (ops/ell_kernel.py: sddmm_table), (slab,
// first slot) per CTA; slot0 (S,) int64: the offset of slab s in the flat
// output.  dY (rows, k) and out are fp32 for an fp32 or bf16 B and fp64 for
// an fp64 B; rows < 2**31.  out_rows (int32, one per slab row, or null): the
// dY row of each slab row (K2's row map).
extern "C" int ell_slabs_sddmm_launch(const void* slabs, const void* items, long long n_items,
                                      const void* slot0, const void* dY, const void* B,
                                      int b_dtype, void* out, long long n, long long k, int vec,
                                      int tpr_log2, const void* out_rows, void* stream) {
  using namespace spmm_tpu_torch;
  if (n_items <= 0) return 0;
  if (n < 1 || n > 0x7fffffffLL || k < 1 || n_items > 0x7fffffff || vec < 1) {
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
  const int* rows = static_cast<const int*>(out_rows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (b_dtype == kF32)
    err = launch<float, float, 4>(sl, it, ni, s0, dY, B, out, n, k, vec, tpr_log2, rows, s);
  else if (b_dtype == kBF16)
    err = launch<__nv_bfloat16, float, 4>(sl, it, ni, s0, dY, B, out, n, k, vec, tpr_log2, rows, s);
  else if (b_dtype == kF64)
    err = launch<double, double, 2>(sl, it, ni, s0, dY, B, out, n, k, vec, tpr_log2, rows, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
