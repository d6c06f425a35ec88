// K1: BSR SpMM on Hopper, Y[m, k] = A_bsr @ B[n_pad, k], in full fp32 (fp32 or
// bf16 operands) or in fp64 (fp64 operands).
//
// Replaces the Pallas TPU kernel spmm_tpu/ops/pallas_bsr.py: bsr_spmm_pallas
// (pl.pallas_call at :69, body _kernel at :26-35).  Same contract: for each
// stored (bm, bn) block b, Y[brow(b)*bm : +bm, :] += data[b] @
// B[block_cols[b]*bn : +bn, :], in full fp32 (the TPU kernel pins
// Precision.HIGHEST; there is no TF32 here, only fp32 FMA on the CUDA cores).
//
// What bounds it on this card: the fp32 FMAs.  At the bench shape (40,864
// (8, 128) blocks, k = 128) the work is 10.7 GFLOP over the stored block
// entries -- 0.160 ms at the 67 TFLOP/s fp32 peak -- against 234 MB of A, B
// and Y, 0.070 ms at 3.35 TB/s.  The first design (one CTA per block row and
// k tile, 8 output rows) stayed at ~20% of that bound: every FMA read its A
// value from shared memory (one LDS per FMA), and each of the 8 block rows
// that share a B tile streamed it from L2 again.
//
// Design:
// - A group plan built once per BSR on the host (ops/bsr_kernel.py:
//   group_plan): G = 64 / bm consecutive block rows form a group of 64
//   output rows; per group the sorted union of its block columns, and per
//   (union column, block row) the block's index or -1.  One CTA of 256
//   threads per (group, 128-wide k tile).  Banded and graph matrices give
//   neighbouring block rows the same block columns, so each B tile is read
//   once per group instead of once per block row (8x fewer at bm = 8).
// - Staging, double-buffered in shared memory, KC = 32 rows of depth per
//   stage: the (KC, 128) B tile by cp.async (16-byte copies, zero-filled past
//   the block's bn), and the group's A columns beside it, transposed to
//   (KC, 64) and widened to fp32 through registers, zero where a block row
//   lacks the column.  The next stage's loads are in flight while the
//   current one is multiplied.
// - The product is SIMT fp32 with a register tile: each thread owns 8 rows x
//   4 columns; per depth step one float4 of B and two of A feed 32 FMAs, so
//   shared memory is read 3 times per 32 FMAs, not once per FMA.  The sums
//   stay in registers and each output tile is written once: no atomics, no
//   second pass, zeros for a group without blocks.
// - Tensor cores: grouping gives the 64 rows wgmma needs, but plain TF32
//   would change the result; a 3xTF32 split is the next step if the SIMT
//   product falls short of its bound.
//
// - fp64 operands run the same kernel with double sums (the card's native
//   fp64 FMA, 34 TFLOP/s outside the tensor cores): the 8 x 4 register tile
//   and the stages double in size (100 KB of shared memory, one CTA of 256
//   threads per SM by its registers).
//
// - Types: the blocks and B may differ between fp32 and bf16 (each widened
//   to fp32 as it is staged or read), so a product of fp32 blocks with a bf16
//   B, or the reverse, needs no cast of the 167 MB of blocks; fp64 takes
//   fp64 for both.
//
// Limits (checked by the Python wrapper): k % 128 == 0, bm <= 64, data and B
// fp32 / bf16 in any mix or both fp64, B 16-byte aligned with n_pad rows.
//
// The transposed product, grad B = A^T . dY (bsr_t_kernel below), has no
// TPU counterpart: it is the backward of this kernel.  It reads A's blocks
// as they are stored -- no re-blocked A^T and no gather of the 41.8M block
// values per call, which cost as much as the product itself before:
// - A plan per BSR (ops/bsr_kernel.py: transposed_plan): the blocks grouped
//   by block column, as group_plan groups them by block row; a group is the
//   bn rows of one block column of A, or 128 // bn block columns when bn <
//   128 (the union of their block rows, per (union row, block column) the
//   block's index or -1), or a 128-row part of one block column when bn >
//   128.  One CTA of 256 threads per (group, 128-wide k tile of dY).
// - The depth is the concatenation of the group's union entries, bm rows
//   each, cut into stages of 32 rows (four (8, 128) blocks a stage).  Per
//   stage, cp.async copies the 32 dY rows (128 columns) and, for each depth
//   row, the matching row of every block of the group -- a stored block row
//   is a row of the transposed block's columns, so the A tile lands in
//   shared memory as the product reads it, with no transpose -- double
//   buffered as above.  Blocks in bf16 are widened where they are read.
// - The product keeps a 16 x 4 register tile per thread (128 x 128 per CTA),
//   and each output tile is written once, in a fixed order of the blocks:
//   no atomics, the same bits on every run.

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;           // output rows per CTA (a group)
constexpr int kTile = 128;          // output columns per CTA
constexpr int kKC = 32;             // depth per stage
constexpr int kAStride = kRows + 4; // padded row of the transposed A stage

// the sums' type: double for fp64 operands, else float
template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

template <typename TD, typename TB>
constexpr size_t smem_bytes() {
  return sizeof(typename Acc<TB>::type) * 2 * kKC * kAStride + sizeof(TB) * 2 * kKC * kTile;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void lds4(const double* p, double* v) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(double* p, const double* v) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float* v) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename TD, typename TB>
__global__ void __launch_bounds__(kThreads, sizeof(TB) == 8 ? 1 : 2)
bsr_group_kernel(const TD* __restrict__ data, const int* __restrict__ gptr,
                 const int* __restrict__ ucols, const int* __restrict__ blk,
                 const TB* __restrict__ B, typename Acc<TB>::type* __restrict__ Y, int G, int bm,
                 int bn, int m, long long k) {
  using TA = typename Acc<TB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);                                    // [2][kKC][kAStride]
  TB* Bs = reinterpret_cast<TB*>(smem + sizeof(TA) * 2 * kKC * kAStride);  // [2][kKC][kTile]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = (warp / 4) * 4 + lane / 8;  // rows rg*8 .. rg*8+7
  const int cg = (warp % 4) * 8 + lane % 8;  // columns cg*4 .. cg*4+3
  const int g = blockIdx.x;
  const long long col0 = static_cast<long long>(blockIdx.y) * kTile;
  const int base = gptr[g];
  const int nU = gptr[g + 1] - base;
  const int nchunk = (bn + kKC - 1) / kKC;
  const int S = nU * nchunk;
  const long long blk_elems = static_cast<long long>(bm) * bn;

  // this thread's A staging slot: tile row a_row, depth a_c8 .. a_c8 + 7
  const int a_row = tid / 4, a_c8 = (tid % 4) * 8;
  const int a_i = a_row / bm, a_rr = a_row % bm;
  const bool a_live = a_i < G;

  TA acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  TA areg[8];
  auto load_a = [&](int s) {
    const int j = s / nchunk, kc = (s % nchunk) * kKC;
    const int b = a_live ? blk[static_cast<long long>(base + j) * G + a_i] : -1;
#pragma unroll
    for (int q = 0; q < 8; ++q) areg[q] = 0;
    if (b >= 0) {
      const TD* src = data + b * blk_elems + static_cast<long long>(a_rr) * bn + kc + a_c8;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (kc + a_c8 + q < bn) areg[q] = to_acc<TA>(src[q]);
    }
  };
  auto store_a = [&](int buf) {
    TA* dst = As + buf * kKC * kAStride;
#pragma unroll
    for (int q = 0; q < 8; ++q) dst[(a_c8 + q) * kAStride + a_row] = areg[q];
  };
  auto issue_b = [&](int s, int buf) {
    constexpr int kPer = 16 / sizeof(TB);      // elements per 16-byte copy
    constexpr int kRowCopies = kTile / kPer;   // copies per tile row
    const int j = s / nchunk, kc = (s % nchunk) * kKC;
    const long long brow0 = static_cast<long long>(ucols[base + j]) * bn + kc;
    TB* dst = Bs + buf * kKC * kTile;
#pragma unroll
    for (int p = 0; p < kKC * kRowCopies / kThreads; ++p) {
      const int q = tid + p * kThreads;
      const int kk = q / kRowCopies, cc = (q % kRowCopies) * kPer;
      const bool live = kc + kk < bn;
      const TB* src = live ? B + (brow0 + kk) * k + col0 + cc : B;
      cp_async16(dst + kk * kTile + cc, src, live ? 16 : 0);
    }
  };

  if (S > 0) {
    load_a(0);
    issue_b(0, 0);
    cp_async_commit();
    store_a(0);
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < S; ++s) {
    const int cur = s & 1;
    if (s + 1 < S) {
      load_a(s + 1);
      issue_b(s + 1, cur ^ 1);
      cp_async_commit();
    }
    const TA* a_t = As + cur * kKC * kAStride + rg * 8;
    const TB* b_t = Bs + cur * kKC * kTile + cg * 4;
#pragma unroll
    for (int kk = 0; kk < kKC; ++kk) {
      TA a[8], b[4];
      lds4(a_t + kk * kAStride, a);
      lds4(a_t + kk * kAStride + 4, a + 4);
      lds4(b_t + kk * kTile, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < S) {
      store_a(cur ^ 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  const long long row_base = static_cast<long long>(g) * G * bm;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int rl = rg * 8 + i;
    const long long row = row_base + rl;
    if (rl < G * bm && row < m) {
      st4(Y + row * k + col0 + cg * 4, acc[i]);
    }
  }
}

// ---- the transposed product: Y[n, k] = A^T . dY[m, k] from A's own blocks ----

constexpr int kRowsT = 128;  // output rows per CTA
constexpr int kTM = 16;      // output rows per thread

template <typename TD, typename TB>
constexpr size_t smem_bytes_t() {
  return sizeof(TD) * 2 * kKC * kRowsT + sizeof(TB) * 2 * kKC * kTile;
}

template <typename TD, typename TB>
__global__ void __launch_bounds__(kThreads, sizeof(TB) == 8 ? 1 : 2)
bsr_t_kernel(const TD* __restrict__ data, const int* __restrict__ gptr,
             const int* __restrict__ ucols, const int* __restrict__ blk,
             const TB* __restrict__ dY, typename Acc<TB>::type* __restrict__ Y, int G, int nsub,
             int bm, int bn, int m, int n, long long k, int vec_a) {
  using TA = typename Acc<TB>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  TD* As = reinterpret_cast<TD*>(smem);                                  // [2][kKC][kRowsT]
  TB* Bs = reinterpret_cast<TB*>(smem + sizeof(TD) * 2 * kKC * kRowsT);  // [2][kKC][kTile]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rg = (warp / 4) * 4 + lane / 8;  // rows rg*16 .. rg*16+15
  const int cg = (warp % 4) * 8 + lane % 8;  // columns cg*4 .. cg*4+3
  const int g = blockIdx.x / nsub, sub = blockIdx.x % nsub;
  const long long col0 = static_cast<long long>(blockIdx.y) * kTile;
  const int base = gptr[g];
  const int nU = gptr[g + 1] - base;
  const int S = (nU * bm + kKC - 1) / kKC;  // stages over the group's depth
  const long long blk_elems = static_cast<long long>(bm) * bn;

  // tile row r: the block of union entry u that holds it, and its column j
  // in that block (-1 where the group holds nothing there)
  auto block_of = [&](int u, int r, int& j) -> int {
    int slot;
    if (nsub == 1) {
      slot = r / bn;
      j = r - slot * bn;
    } else {
      slot = 0;
      j = sub * kRowsT + r;
    }
    return (u < nU && slot < G && j < bn) ? blk[static_cast<long long>(base + u) * G + slot] : -1;
  };

  auto issue = [&](int s, int buf) {
    TB* bdst = Bs + buf * kKC * kTile;
    constexpr int kPerB = 16 / sizeof(TB);
    constexpr int kCopiesB = kTile / kPerB;  // 16-byte copies per dY row
#pragma unroll
    for (int p = 0; p < kKC * kCopiesB / kThreads; ++p) {
      const int q = tid + p * kThreads;
      const int kk = q / kCopiesB, cc = (q % kCopiesB) * kPerB;
      const int vd = s * kKC + kk, u = vd / bm, d = vd - u * bm;
      const long long row = u < nU ? static_cast<long long>(ucols[base + u]) * bm + d : m;
      const bool live = row < m;
      cp_async16(bdst + kk * kTile + cc, live ? dY + row * k + col0 + cc : dY, live ? 16 : 0);
    }
    TD* adst = As + buf * kKC * kRowsT;
    if (vec_a) {  // bn * sizeof(TD) % 16 == 0: a 16-byte copy stays in one block row
      constexpr int kPerA = 16 / sizeof(TD);
      constexpr int kCopiesA = kRowsT / kPerA;
#pragma unroll
      for (int p = 0; p < kKC * kCopiesA / kThreads; ++p) {
        const int q = tid + p * kThreads;
        const int kk = q / kCopiesA, r = (q % kCopiesA) * kPerA;
        const int vd = s * kKC + kk, u = vd / bm, d = vd - u * bm;
        int j;
        const int b = block_of(u, r, j);
        const TD* src = b >= 0 ? data + b * blk_elems + static_cast<long long>(d) * bn + j : data;
        cp_async16(adst + kk * kRowsT + r, src, b >= 0 ? 16 : 0);
      }
    } else {  // element by element; this buffer is not read during the stage
      for (int p = 0; p < kKC * kRowsT / kThreads; ++p) {
        const int q = tid + p * kThreads;
        const int kk = q / kRowsT, r = q % kRowsT;
        const int vd = s * kKC + kk, u = vd / bm, d = vd - u * bm;
        int j;
        const int b = block_of(u, r, j);
        adst[kk * kRowsT + r] =
            b >= 0 ? data[b * blk_elems + static_cast<long long>(d) * bn + j] : static_cast<TD>(0.0f);
      }
    }
  };

  TA acc[kTM][4];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  if (S > 0) {
    issue(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < S; ++s) {
    const int cur = s & 1;
    if (s + 1 < S) {
      issue(s + 1, cur ^ 1);
      cp_async_commit();
    }
    const TD* a_t = As + cur * kKC * kRowsT + rg * kTM;
    const TB* b_t = Bs + cur * kKC * kTile + cg * 4;
#pragma unroll 4
    for (int kk = 0; kk < kKC; ++kk) {
      TA a[kTM], b[4];
#pragma unroll
      for (int i = 0; i < kTM; i += 4) lds4(a_t + kk * kRowsT + i, a + i);
      lds4(b_t + kk * kTile, b);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = mad(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < S) cp_async_wait_all();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = rg * kTM + i;
    long long row;
    if (nsub == 1) {
      if (r >= G * bn) continue;
      row = static_cast<long long>(g) * G * bn + r;
    } else {
      if (sub * kRowsT + r >= bn) continue;
      row = static_cast<long long>(g) * bn + sub * kRowsT + r;
    }
    if (row < n) st4(Y + row * k + col0 + cg * 4, acc[i]);
  }
}

// raise a kernel's dynamic shared memory limit once per instantiation and process
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  done = err == cudaSuccess;
  return err;
}

template <typename TD, typename TB>
cudaError_t launch(const void* data, const int* gptr, const int* ucols, const int* blk,
                   const void* B, void* Y, int ngroups, int G, int bm, int bn, int m, long long k,
                   cudaStream_t s) {
  constexpr size_t smem = smem_bytes<TD, TB>();
  static bool raised = false;
  const cudaError_t err = allow_smem(bsr_group_kernel<TD, TB>, smem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(ngroups), static_cast<unsigned>(k / kTile));
  bsr_group_kernel<TD, TB><<<grid, kThreads, smem, s>>>(
      static_cast<const TD*>(data), gptr, ucols, blk, static_cast<const TB*>(B),
      static_cast<typename Acc<TB>::type*>(Y), G, bm, bn, m, k);
  return cudaGetLastError();
}

template <typename TD, typename TB>
cudaError_t launch_t(const void* data, const int* gptr, const int* ucols, const int* blk,
                     const void* dY, void* Y, int ngroups, int nsub, int G, int bm, int bn, int m,
                     int n, long long k, int vec_a, cudaStream_t s) {
  constexpr size_t smem = smem_bytes_t<TD, TB>();
  static bool raised = false;
  const cudaError_t err = allow_smem(bsr_t_kernel<TD, TB>, smem, raised);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(ngroups) * nsub, static_cast<unsigned>(k / kTile));
  bsr_t_kernel<TD, TB><<<grid, kThreads, smem, s>>>(
      static_cast<const TD*>(data), gptr, ucols, blk, static_cast<const TB*>(dY),
      static_cast<typename Acc<TB>::type*>(Y), G, nsub, bm, bn, m, n, k, vec_a);
  return cudaGetLastError();
}

// the (blocks, B) type pairs both kernels are built for: fp32 and bf16 in any
// mix with fp32 sums, fp64 with fp64
#define SPMM_TPU_TORCH_K1_TYPES(CALL)                                          \
  if (data_dtype == kF32 && b_dtype == kF32) err = CALL(float, float);         \
  else if (data_dtype == kBF16 && b_dtype == kBF16)                            \
    err = CALL(__nv_bfloat16, __nv_bfloat16);                                  \
  else if (data_dtype == kF32 && b_dtype == kBF16) err = CALL(float, __nv_bfloat16); \
  else if (data_dtype == kBF16 && b_dtype == kF32) err = CALL(__nv_bfloat16, float); \
  else if (data_dtype == kF64 && b_dtype == kF64) err = CALL(double, double);  \
  else err = cudaErrorInvalidValue;

}  // namespace
}  // namespace spmm_tpu_torch

// gptr (ngroups + 1,), ucols (nunion,), blk (nunion, G): the group plan
// (ops/bsr_kernel.py: group_plan), int32 on the device.  Y is fp32 for fp32 /
// bf16 operands in any mix, fp64 for fp64.
extern "C" int bsr_spmm_launch(const void* data, const void* gptr, const void* ucols,
                               const void* blk, const void* B, void* Y, int data_dtype,
                               int b_dtype, int ngroups, int G, int bm, int bn, long long k, int m,
                               void* stream) {
  using namespace spmm_tpu_torch;
  if (ngroups <= 0 || k <= 0 || m <= 0) return 0;
  if (k % kTile != 0 || k / kTile > 65535 || bm < 1 || bn < 1 || G < 1 || G * bm > kRows ||
      reinterpret_cast<uintptr_t>(B) % 16 != 0 || reinterpret_cast<uintptr_t>(Y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* gp = static_cast<const int*>(gptr);
  const int* uc = static_cast<const int*>(ucols);
  const int* bk = static_cast<const int*>(blk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SPMM_TPU_TORCH_K1(TD, TB) launch<TD, TB>(data, gp, uc, bk, B, Y, ngroups, G, bm, bn, m, k, s)
  SPMM_TPU_TORCH_K1_TYPES(SPMM_TPU_TORCH_K1)
#undef SPMM_TPU_TORCH_K1
  return static_cast<int>(err);
}

// Y (n, k) = A^T . dY (m, k).  gptr / ucols / blk: the transposed plan
// (ops/bsr_kernel.py: transposed_plan; ucols are A's block rows, blk A's own
// block indices), ngroups groups of G block columns, each cut into nsub parts
// of 128 rows (nsub > 1 only when bn > 128, with G == 1).  vec_a: bn *
// sizeof(blocks' dtype) % 16 == 0 and the blocks 16-byte aligned.
extern "C" int bsr_spmm_t_launch(const void* data, const void* gptr, const void* ucols,
                                 const void* blk, const void* dY, void* Y, int data_dtype,
                                 int b_dtype, int ngroups, int nsub, int G, int bm, int bn,
                                 long long k, int m, int n, int vec_a, void* stream) {
  using namespace spmm_tpu_torch;
  if (ngroups <= 0 || k <= 0 || n <= 0) return 0;
  if (k % kTile != 0 || k / kTile > 65535 || bm < 1 || bn < 1 || G < 1 || nsub < 1 ||
      (nsub > 1 && (G != 1 || bn > nsub * kRowsT)) || (nsub == 1 && G * bn > kRowsT) ||
      static_cast<long long>(ngroups) * nsub > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(dY) % 16 != 0 || reinterpret_cast<uintptr_t>(Y) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* gp = static_cast<const int*>(gptr);
  const int* uc = static_cast<const int*>(ucols);
  const int* bk = static_cast<const int*>(blk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define SPMM_TPU_TORCH_K1T(TD, TB) \
  launch_t<TD, TB>(data, gp, uc, bk, dY, Y, ngroups, nsub, G, bm, bn, m, n, k, vec_a, s)
  SPMM_TPU_TORCH_K1_TYPES(SPMM_TPU_TORCH_K1T)
#undef SPMM_TPU_TORCH_K1T
  return static_cast<int>(err);
}
