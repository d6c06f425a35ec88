// K4 and K5: the slab SpGEMM's numeric phase (ops/slab_spgemm.py) on the card.
//
// No TPU kernel: in the JAX package these stages are XLA device ops --
// _chunk_fetch (spmm_tpu/ops/slab_spgemm.py:1012), _merge_block (:1073) and
// _compact_to_csr (:1280) -- which the port first wrote as torch ops (their
// plain versions, ops/slab_kernel.py).
//
// K4, one class chunk of (R_pad, L) partial-product slots (L a multiple of the
// segment width W; row i of the chunk is row start + i of rowmeta):
// - (a) slab_fetch_launch: the chunk's slots written to device memory, columns
//   with _INT_MAX pads and the values b2_vals * pa_aval in the accumulate
//   type, 0 at pads -- bit-identical to _chunk_fetch (the class-aligned cache
//   of spgemm_plan(expand=True)).
// - (b) slab_fetch_merge_launch: the same slots made in shared memory and
//   never written out, then each row sorted by column and its runs of equal
//   columns merged: (cols_u, vals_u, nuniq) under _merge_block's contract.
// - (c) slab_merge_launch: the same merge reading a cached (R_pad, L) slab.
// K5, slab_compact_launch: one chunk's merged rows copied to their CSR rows.
//
// What bounds them on this card: bytes.  K4 (b) reads the rows' metadata, the
// pa tables and each live pa's B2 segment once and writes the merged rows;
// K4 (c) reads the slab and writes the merged rows; K5 reads and writes the
// live entries.  The work that stood in the way was the torch route's two
// batched sorts per chunk, its gathers and its prefix sums: every slot went
// through device memory four to six times.
//
// Design:
// - A CTA takes a tile of consecutive rows of one chunk, each row padded to
//   Lp = L rounded up to a power of two: Tp / Lp rows for a tile of Tp slots
//   (4,096 in fp32 and pattern mode, 2,048 in fp64), one row when Lp >= Tp.
//   The host computes the layout (ops/slab_kernel.py: tile_layout).
// - Staging: (b) loads each row's (first pa, pa count) and each live pa's B2
//   segment (16-byte loads of the columns where W allows), routing blocks past
//   the row's count, rows past the chunk's count and slots past L to pads;
//   (c) reads the slab, coalesced.  Shared memory holds a column key and a
//   16-bit slot index per padded slot, and the values in slot order.
// - Sort: a bitonic network over each row on the key (column, slot), so equal
//   columns keep their slot order, as the plain version's stable sort does;
//   the last merge stage runs every row ascending.  Each thread holds 16
//   consecutive padded slots as 64-bit keys in registers: partners in one
//   thread compare in registers, partners in one warp by shuffles, and only
//   rows of 1,024 slots and more take passes through shared memory, one
//   barrier each.
// - Merge: a run starts where the column changes; the live starts (not
//   _INT_MAX) are counted per thread over its 16 slots, one block-wide scan
//   gives each its output position, and the thread holding a run's start
//   sums the run directly in slot order, on into the next threads' slots
//   while the column lasts (pattern mode: its length, an exact count).  Slots past a row's nuniq are written _INT_MAX / 0, so the
//   whole output is deterministic.  No atomics: the same inputs give the same
//   bits, and (b) on the tables gives the bits of (c) on the slab (a) built.
// - K5: one warp per merged row, its first nuniq entries copied to
//   indptr[row] on (coalesced); entries at or past nnz_pad are dropped.

#include <cuda_fp16.h>

#include <algorithm>

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kIntMax = 0x7fffffff;

// a product rounded once, never contracted into an FMA with a later add
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }

// element i of a table of dtype `code` widened to TA, rounded as torch's
// .to(TA) rounds it
template <typename TA>
__device__ __forceinline__ TA widen(const void* p, int code, long long i) {
  switch (code) {
    case kF32: return static_cast<TA>(__ldg(static_cast<const float*>(p) + i));
    case kF64: return static_cast<TA>(__ldg(static_cast<const double*>(p) + i));
    case kBF16:
      return static_cast<TA>(
          __bfloat162float(__ushort_as_bfloat16(__ldg(static_cast<const unsigned short*>(p) + i))));
    case kF16:
      return static_cast<TA>(__half2float(__ushort_as_half(__ldg(static_cast<const unsigned short*>(p) + i))));
    case kI32: return static_cast<TA>(__ldg(static_cast<const int*>(p) + i));
    default: return static_cast<TA>(__ldg(static_cast<const long long*>(p) + i));
  }
}

// one product's tables (ops/slab_spgemm.py: _Tables) and one chunk of them
struct Tables {
  const int* b2_cols;   // (nseg_pad, W) B's columns, _INT_MAX pads; the last segment all pads
  const void* b2_vals;  // (nseg_pad, W) B's values (dtype b_code); null in pattern mode
  const int* pa_b2row;  // (npa_pad,) B2 segment of each pa
  const void* pa_aval;  // (npa_pad,) A value of each pa (dtype a_code); null in pattern mode
  const int* rowmeta;   // (nrow_pad, 2) [first pa, pa count] per row in class order
  long long npa_pad;
  long long last_seg;
  long long start;  // the chunk's first row in rowmeta
  int count;        // the chunk's live rows; rows [count, R_pad) have no pa
  int a_code, b_code;
  int W;
  int vec4;  // W % 4 == 0 and b2_cols 16-byte aligned: the columns by int4 loads
};

// Pa block j of chunk row i: calls emit(w, column, value) for its W slots,
// with _INT_MAX and 0 where the block is past the row's pa count or the row
// past the chunk's (the plain version reads the all-pad last segment there)
// and where the B row's last segment is padded.
template <typename TA, bool PATTERN, typename Emit>
__device__ __forceinline__ void fetch_block(const Tables& t, int i, int j, Emit emit) {
  int base = 0, nb = 0;
  if (i < t.count) {
    const long long m = 2 * (t.start + i);
    base = __ldg(t.rowmeta + m);
    nb = __ldg(t.rowmeta + m + 1);
  }
  const int W = t.W;
  if (j >= nb) {
    for (int w = 0; w < W; ++w) emit(w, kIntMax, TA(0));
    return;
  }
  const long long pa = min(max(static_cast<long long>(base) + j, 0LL), t.npa_pad - 1);
  const long long seg = min(max(static_cast<long long>(__ldg(t.pa_b2row + pa)), 0LL), t.last_seg);
  TA av = TA(0);
  if (!PATTERN) av = widen<TA>(t.pa_aval, t.a_code, pa);
  const int* cp = t.b2_cols + seg * W;
  auto one = [&](int w, int c) {
    TA v = TA(0);
    if (!PATTERN && c != kIntMax) v = mul_rn(widen<TA>(t.b2_vals, t.b_code, seg * W + w), av);
    emit(w, c, v);
  };
  if (t.vec4) {
    for (int w = 0; w < W; w += 4) {
      const int4 c4 = __ldg(reinterpret_cast<const int4*>(cp + w));
      one(w, c4.x);
      one(w + 1, c4.y);
      one(w + 2, c4.z);
      one(w + 3, c4.w);
    }
  } else {
    for (int w = 0; w < W; ++w) one(w, __ldg(cp + w));
  }
}

// K4 (a): (R_pad, L) columns and values of one chunk, one thread per pa block
template <typename TA, bool PATTERN>
__global__ void slab_fetch_kernel(Tables t, int L, long long nblocks, int* __restrict__ col,
                                  TA* __restrict__ val) {
  const int nblk = L / t.W;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; q < nblocks;
       q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int i = static_cast<int>(q / nblk), j = static_cast<int>(q % nblk);
    const long long o = static_cast<long long>(i) * L + static_cast<long long>(j) * t.W;
    fetch_block<TA, PATTERN>(t, i, j, [&](int w, int c, TA v) {
      col[o + w] = c;
      if (!PATTERN) val[o + w] = v;
    });
  }
}

// slots per thread of the merge: a tile of Tp slots takes Tp / kPer threads
constexpr int kPer = 16;

// a slot's sort key, (column, slot index) as one integer: the column in bits
// 16-46, the slot (< 2^16) below
__device__ __forceinline__ unsigned long long pack(int col, int slot) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(col)) << 16) | static_cast<unsigned>(slot);
}
__device__ __forceinline__ int col_of(unsigned long long k) { return static_cast<int>(k >> 16); }
__device__ __forceinline__ int slot_of(unsigned long long k) { return static_cast<int>(k & 0xffffu); }

// a thread's kPer keys to and from shared memory (columns, slot indices),
// 16-byte accesses
__device__ __forceinline__ void store_keys(const unsigned long long (&r)[kPer], int* sk, unsigned short* si,
                                           int s0) {
#pragma unroll
  for (int x = 0; x < kPer; x += 4) {
    reinterpret_cast<int4*>(sk + s0)[x / 4] =
        make_int4(col_of(r[x]), col_of(r[x + 1]), col_of(r[x + 2]), col_of(r[x + 3]));
  }
#pragma unroll
  for (int x = 0; x < kPer; x += 8) {
    uint4 u;
    u.x = slot_of(r[x]) | (slot_of(r[x + 1]) << 16);
    u.y = slot_of(r[x + 2]) | (slot_of(r[x + 3]) << 16);
    u.z = slot_of(r[x + 4]) | (slot_of(r[x + 5]) << 16);
    u.w = slot_of(r[x + 6]) | (slot_of(r[x + 7]) << 16);
    reinterpret_cast<uint4*>(si + s0)[x / 8] = u;
  }
}

__device__ __forceinline__ void load_keys(unsigned long long (&r)[kPer], const int* sk, const unsigned short* si,
                                          int s0) {
#pragma unroll
  for (int x = 0; x < kPer; x += 8) {
    const int4 c0 = reinterpret_cast<const int4*>(sk + s0)[x / 4];
    const int4 c1 = reinterpret_cast<const int4*>(sk + s0)[x / 4 + 1];
    const uint4 u = reinterpret_cast<const uint4*>(si + s0)[x / 8];
    r[x] = pack(c0.x, u.x & 0xffffu);
    r[x + 1] = pack(c0.y, u.x >> 16);
    r[x + 2] = pack(c0.z, u.y & 0xffffu);
    r[x + 3] = pack(c0.w, u.y >> 16);
    r[x + 4] = pack(c1.x, u.z & 0xffffu);
    r[x + 5] = pack(c1.y, u.z >> 16);
    r[x + 6] = pack(c1.z, u.w & 0xffffu);
    r[x + 7] = pack(c1.w, u.w >> 16);
  }
}

// K4 (b) with FETCH, (c) without: one tile of rows_t rows per CTA, kPer
// consecutive padded slots per thread.  Shared memory: values (Tp, TA; none in
// pattern mode), columns (Tp int32), slot indices (Tp uint16), the rows' output
// offsets (rows_t + 1) and 32 warp totals.
template <typename TA, bool PATTERN, bool FETCH>
__global__ void __launch_bounds__(1024) slab_merge_kernel(
    Tables t, const int* __restrict__ col_in, const TA* __restrict__ val_in, int R_pad, int L,
    int lp_log2, int rows_t, int* __restrict__ cols_u, TA* __restrict__ vals_u, int* __restrict__ nuniq) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Lp = 1 << lp_log2;
  const int Tp = rows_t << lp_log2;
  TA* sv = reinterpret_cast<TA*>(smem);
  int* sk = reinterpret_cast<int*>(smem + (PATTERN ? 0 : static_cast<size_t>(Tp) * sizeof(TA)));
  unsigned short* si = reinterpret_cast<unsigned short*>(sk + Tp);
  int* sbase = reinterpret_cast<int*>(si + Tp);
  int* swarp = sbase + rows_t + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r0 = blockIdx.x * rows_t;
  const int s0 = tid * kPer;

  // 1. stage the tile: the column and value of every padded slot (a slot's
  //    index is its place in its row)
  for (int s = tid; s < Tp; s += nt) {
    const int row = s >> lp_log2, e = s & (Lp - 1);
    if (e >= L || r0 + row >= R_pad) {
      sk[s] = kIntMax;
    } else if (!FETCH) {
      const long long g = static_cast<long long>(r0 + row) * L + e;
      sk[s] = __ldg(col_in + g);
      if (!PATTERN) sv[s] = __ldg(val_in + g);
    }
  }
  if (FETCH) {
    const int nblk = L / t.W;
    for (int q = tid; q < rows_t * nblk; q += nt) {
      const int row = q / nblk, j = q % nblk;
      if (r0 + row >= R_pad) continue;
      const int o = (row << lp_log2) + j * t.W;
      fetch_block<TA, PATTERN>(t, r0 + row, j, [&](int w, int c, TA v) {
        sk[o + w] = c;
        if (!PATTERN) sv[o + w] = v;
      });
    }
  }
  __syncthreads();

  // 2. bitonic sort of every row on (column, slot), the keys in registers:
  //    partners within a thread compare in registers, within a warp by
  //    shuffles, further apart (rows of 1,024 slots and more) through shared
  //    memory; the last stage runs every row ascending
  unsigned long long r[kPer];
#pragma unroll
  for (int x = 0; x < kPer; x += 4) {
    const int4 c = reinterpret_cast<const int4*>(sk + s0)[x / 4];
    r[x] = pack(c.x, (s0 + x) & (Lp - 1));
    r[x + 1] = pack(c.y, (s0 + x + 1) & (Lp - 1));
    r[x + 2] = pack(c.z, (s0 + x + 2) & (Lp - 1));
    r[x + 3] = pack(c.w, (s0 + x + 3) & (Lp - 1));
  }
  for (int k = 2; k <= Lp; k <<= 1) {
    int j = k >> 1;
    if (j >= 32 * kPer) {
      store_keys(r, sk, si, s0);
      __syncthreads();
      for (; j >= 32 * kPer; j >>= 1) {
        for (int u = tid; u < (Tp >> 1); u += nt) {
          const int a = 2 * u - (u & (j - 1)), b = a + j;
          const bool up = k == Lp || (a & k) == 0;
          const int ka = sk[a], kb = sk[b];
          const unsigned short ia = si[a], ib = si[b];
          if ((ka > kb || (ka == kb && ia > ib)) == up) {
            sk[a] = kb;
            sk[b] = ka;
            si[a] = ib;
            si[b] = ia;
          }
        }
        __syncthreads();
      }
      load_keys(r, sk, si, s0);
    }
    for (; j >= kPer; j >>= 1) {
      const bool lower = (s0 & j) == 0;
      const bool up = k == Lp || (s0 & k) == 0;
#pragma unroll
      for (int x = 0; x < kPer; ++x) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, r[x], j / kPer);
        r[x] = (lower == up) == (o < r[x]) ? o : r[x];
      }
    }
#pragma unroll
    for (int jj = kPer / 2; jj >= 1; jj >>= 1) {
      if (jj < k) {
#pragma unroll
        for (int x = 0; x < kPer; ++x) {
          if ((x & jj) == 0) {
            const bool up = k == Lp || ((s0 + x) & k) == 0;
            const unsigned long long a = r[x], b = r[x | jj];
            if ((a > b) == up) {
              r[x] = b;
              r[x | jj] = a;
            }
          }
        }
      }
    }
  }
  store_keys(r, sk, si, s0);
  __syncthreads();

  // 3. output positions: the live run starts among the thread's slots, one
  //    block-wide exclusive scan of their counts, each row's offset
  const int lane = tid & 31, warp = tid >> 5;
  unsigned starts = 0;
  {
    int prev = s0 > 0 ? sk[s0 - 1] : kIntMax;
#pragma unroll
    for (int x = 0; x < kPer; ++x) {
      const int c = col_of(r[x]);
      if (c != kIntMax && (((s0 + x) & (Lp - 1)) == 0 || c != prev)) starts |= 1u << x;
      prev = c;
    }
  }
  const int cnt = __popc(starts);
  int incl = cnt;
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) swarp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (nt >> 5) ? swarp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += x;
    }
    swarp[lane] = w;
  }
  __syncthreads();
  const int off = (warp > 0 ? swarp[warp - 1] : 0) + incl - cnt;
  int run = off;
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    if (((s0 + x) & (Lp - 1)) == 0) sbase[(s0 + x) >> lp_log2] = run;
    run += (starts >> x) & 1;
  }
  if (tid == nt - 1) sbase[rows_t] = run;
  __syncthreads();

  // 4. each run summed in slot order by the thread holding its start: one
  //    pass over the thread's slots, the last run followed on into the next
  //    threads' slots while its column lasts
  run = off;
  long long g = -1;  // the open run's output slot
  int cc = 0, crb = 0;
  TA sum = TA(0);
#pragma unroll
  for (int x = 0; x < kPer; ++x) {
    const int c = col_of(r[x]);
    if ((starts >> x) & 1) {
      if (g >= 0) {
        cols_u[g] = cc;
        vals_u[g] = sum;
      }
      const int row = (s0 + x) >> lp_log2;
      crb = row << lp_log2;
      g = static_cast<long long>(r0 + row) * L + (run - sbase[row]);
      ++run;
      cc = c;
      sum = PATTERN ? TA(1) : sv[crb + slot_of(r[x])];
    } else if (g >= 0 && c == cc) {
      sum = sum + (PATTERN ? TA(1) : sv[crb + slot_of(r[x])]);
    } else if (g >= 0) {
      cols_u[g] = cc;
      vals_u[g] = sum;
      g = -1;
    }
  }
  if (g >= 0) {
    for (int q = s0 + kPer; q < crb + Lp && sk[q] == cc; ++q) sum = sum + (PATTERN ? TA(1) : sv[crb + si[q]]);
    cols_u[g] = cc;
    vals_u[g] = sum;
  }

  // 5. nuniq, and the slots past it
  for (int s = tid; s < Tp; s += nt) {
    const int row = s >> lp_log2, e = s & (Lp - 1), i = r0 + row;
    if (e >= L || i >= R_pad) continue;
    const int nu = sbase[row + 1] - sbase[row];
    if (e == 0) nuniq[i] = nu;
    if (e >= nu) {
      const long long g = static_cast<long long>(i) * L + e;
      cols_u[g] = kIntMax;
      vals_u[g] = TA(0);
    }
  }
}

// K5: merged row i of a chunk (class-order row id rows[i]) to its CSR row
template <typename TA>
__global__ void slab_compact_kernel(const int* __restrict__ rows, const int* __restrict__ cols_u,
                                    const TA* __restrict__ vals_u, const int* __restrict__ nuniq, int R_pad,
                                    int L, const long long* __restrict__ indptr, long long nrow,
                                    long long nnz_pad, TA* __restrict__ data, int* __restrict__ indices) {
  const int lane = threadIdx.x & 31;
  const long long nwarps = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  for (long long i = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5; i < R_pad;
       i += nwarps) {
    const int nu = __ldg(nuniq + i);
    const long long r = __ldg(rows + i);
    if (nu <= 0 || r < 0 || r >= nrow) continue;
    const long long base = __ldg(indptr + r);
    const long long src = i * L;
    for (int p = lane; p < nu; p += 32) {
      const long long d = base + p;
      if (d < nnz_pad) {
        indices[d] = __ldg(cols_u + src + p);
        data[d] = __ldg(vals_u + src + p);
      }
    }
  }
}

Tables make_tables(const void* b2_cols, const void* b2_vals, int b_code, const void* pa_b2row,
                   const void* pa_aval, int a_code, const void* rowmeta, long long npa_pad,
                   long long nseg_pad, long long start, int count, int W, int vec4) {
  Tables t;
  t.b2_cols = static_cast<const int*>(b2_cols);
  t.b2_vals = b2_vals;
  t.pa_b2row = static_cast<const int*>(pa_b2row);
  t.pa_aval = pa_aval;
  t.rowmeta = static_cast<const int*>(rowmeta);
  t.npa_pad = npa_pad;
  t.last_seg = nseg_pad - 1;
  t.start = start;
  t.count = count;
  t.a_code = a_code;
  t.b_code = b_code;
  t.W = W;
  t.vec4 = vec4;
  return t;
}

bool value_code(int code) {
  return code == kF32 || code == kF64 || code == kBF16 || code == kF16 || code == kI32 || code == kI64;
}

unsigned grid_of(long long items, int per_cta) {
  const long long g = (items + per_cta - 1) / per_cta;
  return static_cast<unsigned>(std::min<long long>(std::max<long long>(g, 1), 132LL * 32));
}

template <typename TA, bool PATTERN, bool FETCH>
cudaError_t launch_merge(const Tables& t, const void* col_in, const void* val_in, int R_pad, int L,
                         int lp_log2, int rows_t, int threads, long long smem, void* cols_u, void* vals_u,
                         void* nuniq, cudaStream_t s) {
  auto kern = slab_merge_kernel<TA, PATTERN, FETCH>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (R_pad + rows_t - 1) / rows_t;
  kern<<<static_cast<unsigned>(tiles), threads, static_cast<size_t>(smem), s>>>(
      t, static_cast<const int*>(col_in), static_cast<const TA*>(val_in), R_pad, L, lp_log2, rows_t,
      static_cast<int*>(cols_u), static_cast<TA*>(vals_u), static_cast<int*>(nuniq));
  return cudaGetLastError();
}

template <bool FETCH>
int merge_entry(const Tables& t, const void* col_in, const void* val_in, int R_pad, int L, int acc_code,
                int pattern, int lp_log2, int rows_t, int threads, long long smem, void* cols_u, void* vals_u,
                void* nuniq, cudaStream_t s) {
  const int Tp = rows_t << lp_log2;
  if (R_pad <= 0 || L <= 0 || L > (1 << lp_log2) || lp_log2 > 16 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || Tp != kPer * threads || smem > 232448 || (FETCH && (t.W <= 0 || L % t.W != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (acc_code == kF32)
    err = pattern ? launch_merge<float, true, FETCH>(t, col_in, val_in, R_pad, L, lp_log2, rows_t, threads, smem,
                                                     cols_u, vals_u, nuniq, s)
                  : launch_merge<float, false, FETCH>(t, col_in, val_in, R_pad, L, lp_log2, rows_t, threads,
                                                      smem, cols_u, vals_u, nuniq, s);
  else if (acc_code == kF64)
    err = pattern ? launch_merge<double, true, FETCH>(t, col_in, val_in, R_pad, L, lp_log2, rows_t, threads,
                                                      smem, cols_u, vals_u, nuniq, s)
                  : launch_merge<double, false, FETCH>(t, col_in, val_in, R_pad, L, lp_log2, rows_t, threads,
                                                       smem, cols_u, vals_u, nuniq, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace spmm_tpu_torch

// The tables of one product (int32 b2_cols (nseg_pad, W), pa_b2row (npa_pad,),
// rowmeta (nrow_pad, 2); b2_vals / pa_aval of dtypes b_code / a_code, null in
// pattern mode; all contiguous) and one chunk of it: rows [start, start +
// R_pad) of rowmeta, of which the first `count` are live, L slots each.
// acc_code: float32 or float64.

// K4 (a): col (R_pad, L) int32 and, unless pattern, val (R_pad, L) in acc.
extern "C" int slab_fetch_launch(const void* b2_cols, const void* b2_vals, int b_code, const void* pa_b2row,
                                 const void* pa_aval, int a_code, const void* rowmeta, long long npa_pad,
                                 long long nseg_pad, long long start, int count, int R_pad, int L, int W,
                                 int vec4, int acc_code, int pattern, void* col, void* val, void* stream) {
  using namespace spmm_tpu_torch;
  if (W <= 0 || L % W != 0 || R_pad < 0 || npa_pad <= 0 || nseg_pad <= 0 ||
      (!pattern && (!value_code(a_code) || !value_code(b_code)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nblocks = static_cast<long long>(R_pad) * (L / W);
  if (nblocks == 0) return 0;
  const Tables t = make_tables(b2_cols, b2_vals, b_code, pa_b2row, pa_aval, a_code, rowmeta, npa_pad, nseg_pad,
                               start, count, W, vec4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(nblocks, 256);
  int* c = static_cast<int*>(col);
  if (acc_code == kF32) {
    if (pattern)
      slab_fetch_kernel<float, true><<<grid, 256, 0, s>>>(t, L, nblocks, c, nullptr);
    else
      slab_fetch_kernel<float, false><<<grid, 256, 0, s>>>(t, L, nblocks, c, static_cast<float*>(val));
  } else if (acc_code == kF64) {
    if (pattern)
      slab_fetch_kernel<double, true><<<grid, 256, 0, s>>>(t, L, nblocks, c, nullptr);
    else
      slab_fetch_kernel<double, false><<<grid, 256, 0, s>>>(t, L, nblocks, c, static_cast<double*>(val));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4 (b): the chunk fetched and merged in one pass.  Outputs cols_u (R_pad, L)
// int32, vals_u (R_pad, L) in acc, nuniq (R_pad,) int32.  The tile layout
// (lp_log2, rows_t, threads, smem bytes) is ops/slab_kernel.py: tile_layout's.
extern "C" int slab_fetch_merge_launch(const void* b2_cols, const void* b2_vals, int b_code,
                                       const void* pa_b2row, const void* pa_aval, int a_code,
                                       const void* rowmeta, long long npa_pad, long long nseg_pad,
                                       long long start, int count, int R_pad, int L, int W, int vec4,
                                       int acc_code, int pattern, int lp_log2, int rows_t, int threads,
                                       long long smem, void* cols_u, void* vals_u, void* nuniq, void* stream) {
  using namespace spmm_tpu_torch;
  if (npa_pad <= 0 || nseg_pad <= 0 || (!pattern && (!value_code(a_code) || !value_code(b_code)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables t = make_tables(b2_cols, b2_vals, b_code, pa_b2row, pa_aval, a_code, rowmeta, npa_pad, nseg_pad,
                               start, count, W, vec4);
  return merge_entry<true>(t, nullptr, nullptr, R_pad, L, acc_code, pattern, lp_log2, rows_t, threads, smem,
                           cols_u, vals_u, nuniq, static_cast<cudaStream_t>(stream));
}

// K4 (c): the merge of a cached slab, col (R_pad, L) int32 and, unless
// pattern, val (R_pad, L) in acc; outputs as (b).
extern "C" int slab_merge_launch(const void* col, const void* val, int R_pad, int L, int acc_code, int pattern,
                                 int lp_log2, int rows_t, int threads, long long smem, void* cols_u,
                                 void* vals_u, void* nuniq, void* stream) {
  using namespace spmm_tpu_torch;
  Tables t{};
  return merge_entry<false>(t, col, val, R_pad, L, acc_code, pattern, lp_log2, rows_t, threads, smem, cols_u,
                            vals_u, nuniq, static_cast<cudaStream_t>(stream));
}

// K5: one chunk's merged rows (rows (R_pad,) int32 row ids, cols_u (R_pad, L)
// int32, vals_u (R_pad, L) in acc, nuniq (R_pad,) int32) into the CSR arrays
// data (nnz_pad,) in acc and indices (nnz_pad,) int32 at indptr (nrow + 1,)
// int64.
extern "C" int slab_compact_launch(const void* rows, const void* cols_u, const void* vals_u, const void* nuniq,
                                   int R_pad, int L, const void* indptr, long long nrow, long long nnz_pad,
                                   int acc_code, void* data, void* indices, void* stream) {
  using namespace spmm_tpu_torch;
  if (R_pad < 0 || L < 0 || nrow < 0 || nnz_pad < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R_pad == 0 || L == 0 || nnz_pad == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(R_pad, 8);
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols_u);
  const int* nu = static_cast<const int*>(nuniq);
  const long long* ip = static_cast<const long long*>(indptr);
  int* ind = static_cast<int*>(indices);
  if (acc_code == kF32)
    slab_compact_kernel<float><<<grid, 256, 0, s>>>(r, c, static_cast<const float*>(vals_u), nu, R_pad, L, ip,
                                                    nrow, nnz_pad, static_cast<float*>(data), ind);
  else if (acc_code == kF64)
    slab_compact_kernel<double><<<grid, 256, 0, s>>>(r, c, static_cast<const double*>(vals_u), nu, R_pad, L, ip,
                                                     nrow, nnz_pad, static_cast<double*>(data), ind);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
