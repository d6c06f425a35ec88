// K1: BSR SpMM on Hopper, Y[m, k] = A_bsr @ B[n_pad, k], fp32 accumulation.
//
// Replaces the Pallas TPU kernel spmm_tpu/ops/pallas_bsr.py: bsr_spmm_pallas
// (pl.pallas_call at :69, body _kernel at :26-35).  Same contract: for each
// stored (bm, bn) block b in CSR block order, Y[brow(b)*bm : +bm, :] +=
// data[b] @ B[block_cols[b]*bn : +bn, :], in full fp32 (the TPU kernel pins
// Precision.HIGHEST; there is no TF32 here, only fp32 FMA).
//
// What bounds it on this card: every B element that a block reads is used bm
// times (8 at the default (8, 128) block), i.e. 2*bm FLOP per 4-byte load in
// fp32 -- far below the H100's FLOP/byte balance.  So the kernel is bound by
// the bytes of B tiles it streams (from L2 when neighbouring block rows share
// block columns, else from HBM) and by load latency, not by arithmetic; the
// tensor cores (wgmma needs M >= 64 rows) would not help an 8-row block.
//
// Design: one CTA of 128 threads per (block row, 128-wide k tile).  Thread t
// owns column t of the tile and keeps its bm sums in registers.  The CTA walks
// block_indptr[br] .. block_indptr[br+1]; for each block it stages the (bm, bn)
// A block in shared memory (bf16 widened to fp32 on load; every thread reads
// it by broadcast), and each thread streams its column of the (bn, 128) B tile
// straight from global memory -- one warp reads 128 contiguous bytes of a B
// row per step.  Each B element is used by exactly one thread, so staging the
// B tile in shared memory would add a copy and no reuse.  Because one CTA owns
// each output tile, there are no atomics and no second pass: the tile is
// written once at the end, zeros for an empty block row.  This replaces the
// TPU's "zero the resident tile when the block row changes" (pallas_bsr.py:
// 29-31), which needed csr_to_bsr's inserted zero blocks; those blocks are
// kept for format parity and simply add zeros here.
//
// Limits (checked by the Python wrapper): k % 128 == 0, bm <= 32 (register
// sums), bm * bn * 4 bytes <= 48 KB of shared memory, data and B of one dtype
// (fp32 or bf16).

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kTile = 128;  // output columns per CTA, one per thread

template <typename T, int MAX_BM>
__global__ void __launch_bounds__(kTile)
bsr_spmm_kernel(const T* __restrict__ data, const int* __restrict__ block_indptr,
                const int* __restrict__ block_cols, const T* __restrict__ B,
                float* __restrict__ Y, int bm, int bn, int m, int64_t k) {
  extern __shared__ float a_blk[];  // (bm, bn) fp32
  const int br = blockIdx.x;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kTile + threadIdx.x;
  const int blk_elems = bm * bn;

  float acc[MAX_BM];
#pragma unroll
  for (int r = 0; r < MAX_BM; ++r) acc[r] = 0.f;

  const int lo = block_indptr[br];
  const int hi = block_indptr[br + 1];
  for (int b = lo; b < hi; ++b) {
    const T* a = data + static_cast<int64_t>(b) * blk_elems;
    __syncthreads();  // every thread is done with the previous block
    for (int i = threadIdx.x; i < blk_elems; i += kTile) a_blk[i] = to_f32(a[i]);
    __syncthreads();
    const T* bt = B + static_cast<int64_t>(block_cols[b]) * bn * k + col;
#pragma unroll 4
    for (int c = 0; c < bn; ++c) {
      const float bv = to_f32(bt[static_cast<int64_t>(c) * k]);
#pragma unroll
      for (int r = 0; r < MAX_BM; ++r)
        if (r < bm) acc[r] = fmaf(a_blk[r * bn + c], bv, acc[r]);
    }
  }

  const int row0 = br * bm;
#pragma unroll
  for (int r = 0; r < MAX_BM; ++r)
    if (r < bm && row0 + r < m) Y[static_cast<int64_t>(row0 + r) * k + col] = acc[r];
}

template <typename T>
cudaError_t launch(const void* data, const int* indptr, const int* bcols, const void* B,
                   float* Y, int nbrows, int bm, int bn, int m, int64_t k, cudaStream_t s) {
  const dim3 grid(nbrows, static_cast<unsigned>(k / kTile));
  const size_t smem = sizeof(float) * bm * bn;
  const T* d = static_cast<const T*>(data);
  const T* b = static_cast<const T*>(B);
#define SPMM_TPU_TORCH_BSR(MAXBM) \
  bsr_spmm_kernel<T, MAXBM><<<grid, kTile, smem, s>>>(d, indptr, bcols, b, Y, bm, bn, m, k)
  if (bm <= 1) SPMM_TPU_TORCH_BSR(1);
  else if (bm <= 2) SPMM_TPU_TORCH_BSR(2);
  else if (bm <= 4) SPMM_TPU_TORCH_BSR(4);
  else if (bm <= 8) SPMM_TPU_TORCH_BSR(8);
  else if (bm <= 16) SPMM_TPU_TORCH_BSR(16);
  else if (bm <= 32) SPMM_TPU_TORCH_BSR(32);
  else return cudaErrorInvalidValue;
#undef SPMM_TPU_TORCH_BSR
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmm_tpu_torch

extern "C" int bsr_spmm_launch(const void* data, const void* block_indptr,
                               const void* block_cols, const void* B, void* Y, int dtype,
                               int nbrows, int bm, int bn, long long k, int m, void* stream) {
  using namespace spmm_tpu_torch;
  if (nbrows <= 0 || k <= 0) return 0;
  if (k % kTile != 0 || bm < 1 || bn < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int* indptr = static_cast<const int*>(block_indptr);
  const int* bcols = static_cast<const int*>(block_cols);
  float* y = static_cast<float*>(Y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float>(data, indptr, bcols, B, y, nbrows, bm, bn, m, k, s);
  else if (dtype == kBF16)
    err = launch<__nv_bfloat16>(data, indptr, bcols, B, y, nbrows, bm, bn, m, k, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
