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
// Limits (checked by the Python wrapper): k % 128 == 0, bm <= 64, data and B
// of one dtype (fp32, bf16 or fp64), B 16-byte aligned with n_pad rows.

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

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(typename Acc<T>::type) * 2 * kKC * kAStride + sizeof(T) * 2 * kKC * kTile;
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

template <typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 8 ? 1 : 2)
bsr_group_kernel(const T* __restrict__ data, const int* __restrict__ gptr,
                 const int* __restrict__ ucols, const int* __restrict__ blk,
                 const T* __restrict__ B, typename Acc<T>::type* __restrict__ Y, int G, int bm,
                 int bn, int m, long long k) {
  using TA = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  TA* As = reinterpret_cast<TA*>(smem);                                  // [2][kKC][kAStride]
  T* Bs = reinterpret_cast<T*>(smem + sizeof(TA) * 2 * kKC * kAStride);  // [2][kKC][kTile]

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
      const T* src = data + b * blk_elems + static_cast<long long>(a_rr) * bn + kc + a_c8;
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
    constexpr int kPer = 16 / sizeof(T);       // elements per 16-byte copy
    constexpr int kRowCopies = kTile / kPer;   // copies per tile row
    const int j = s / nchunk, kc = (s % nchunk) * kKC;
    const long long brow0 = static_cast<long long>(ucols[base + j]) * bn + kc;
    T* dst = Bs + buf * kKC * kTile;
#pragma unroll
    for (int p = 0; p < kKC * kRowCopies / kThreads; ++p) {
      const int q = tid + p * kThreads;
      const int kk = q / kRowCopies, cc = (q % kRowCopies) * kPer;
      const bool live = kc + kk < bn;
      const T* src = live ? B + (brow0 + kk) * k + col0 + cc : B;
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
    const T* b_t = Bs + cur * kKC * kTile + cg * 4;
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

template <typename T>
cudaError_t launch(const void* data, const int* gptr, const int* ucols, const int* blk,
                   const void* B, void* Y, int ngroups, int G, int bm, int bn, int m, long long k,
                   cudaStream_t s) {
  constexpr size_t smem = smem_bytes<T>();
  static bool smem_raised = false;  // once per instantiation and process
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_group_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_raised = true;
  }
  const dim3 grid(static_cast<unsigned>(ngroups), static_cast<unsigned>(k / kTile));
  bsr_group_kernel<T><<<grid, kThreads, smem, s>>>(static_cast<const T*>(data), gptr, ucols, blk,
                                                  static_cast<const T*>(B),
                                                  static_cast<typename Acc<T>::type*>(Y), G, bm,
                                                  bn, m, k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmm_tpu_torch

// gptr (ngroups + 1,), ucols (nunion,), blk (nunion, G): the group plan
// (ops/bsr_kernel.py: group_plan), int32 on the device.  Y is fp32 for fp32 and
// bf16 operands, fp64 for fp64.
extern "C" int bsr_spmm_launch(const void* data, const void* gptr, const void* ucols,
                               const void* blk, const void* B, void* Y, int dtype, int ngroups,
                               int G, int bm, int bn, long long k, int m, void* stream) {
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
  if (dtype == kF32)
    err = launch<float>(data, gp, uc, bk, B, Y, ngroups, G, bm, bn, m, k, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(data, gp, uc, bk, B, Y, ngroups, G, bm, bn, m, k, s);
  else if (dtype == kF64)
    err = launch<double>(data, gp, uc, bk, B, Y, ngroups, G, bm, bn, m, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
