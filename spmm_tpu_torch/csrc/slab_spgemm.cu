// K4 and K5: the slab SpGEMM's numeric phase (ops/slab_spgemm.py) on the card.
//
// No TPU kernel: in the JAX package these stages are XLA device ops --
// _chunk_fetch (spmm_tpu/ops/slab_spgemm.py:1012), _merge_block (:1073) and
// _compact_to_csr (:1280) -- which the port first wrote as torch ops (their
// plain versions, ops/slab_kernel.py).
//
// K4, class chunks of (R_pad, L) partial-product slots (L a multiple of the
// segment width W; row i of a chunk is row start + i of rowmeta):
// - (a) slab_fetch_launch: every chunk's slots (up to 64 chunks a launch)
//   written to device memory, columns with _INT_MAX pads and the values
//   b2_vals * pa_aval in the accumulate type, 0 at pads -- bit-identical to
//   _chunk_fetch (the class-aligned cache of spgemm_plan(expand=True)).
// - (b) slab_merge_launch with the tables: every chunk of a product fetched
//   into shared memory (never written out), then each row sorted by column
//   and its runs of equal columns merged: (cols_u, vals_u, nuniq) under
//   _merge_block's contract.
// - (c) slab_merge_launch without them: the same merge reading cached slabs.
// K5, slab_compact_counts_launch + slab_compact_launch: the chunks' merged
// rows copied to their CSR rows.
//
// What bounds them on this card: bytes.  K4 (a) reads the rows' metadata,
// the pa tables and each live pa's B2 segment and writes every slot; K4 (b) reads the rows' metadata, the
// pa tables and each live pa's B2 segment once and writes the merged rows;
// K4 (c) reads the slabs and writes the merged rows; K5 reads and writes the
// live entries and zeroes the CSR's padding.
//
// Design of the fetch (one launch per plan): the host's chunk table
// (ops/slab_kernel.py: fetch_plan) numbers the 16-byte pieces of four
// consecutive slots of every chunk, each chunk's slab at a 16-byte aligned
// slot of one allocation.  Consecutive threads take consecutive pieces, so
// a warp's 16-byte stores cover 512 contiguous bytes of columns (1,024 of
// fp64 values), streamed past L2.  Each thread takes four pieces and starts
// their dependent loads a level at a time -- rowmeta, then pa_b2row (and
// pa_aval), then the B2 segment's four columns (and values) by 16-byte
// loads -- so a thread pays the three-load chain once for four pieces; a
// piece past its row's pa count or its chunk's live rows loads nothing.
// Tables in the accumulate type are read without the per-slot dtype switch.
// For W % 4 != 0 or unaligned tables, a thread takes one piece whose four
// slots each walk the chain.
//
// Design of the merge (one launch per product and block size):
// - The host's chunk table (ops/slab_kernel.py: merge_plan) gives each chunk
//   its tiles: rows_t consecutive rows of L slots, rows_t = T / L for a tile
//   of T = NT * E slots (2,048 for L <= 2,048, 4,096 up to 4,096, 16,384
//   above).  The table travels as a kernel parameter; a CTA finds its chunk
//   in it and stages its rows unpadded, in slot order: (c) by 16-byte loads
//   of the contiguous slab rows, (b) by its rows' (first pa, pa count), then
//   each live pa's B2 segment.  Shared memory holds the columns, the values
//   and a 16-bit run start per slot: 14 B a slot in fp64, 229,376 of a CTA's
//   232,448 B at 16,384 slots.
// - Sort: a row's slots are ascending runs (one per B row, when B's rows
//   ascend).  A run starts at a row's first slot and wherever a column is
//   below its predecessor; a row's live length ends after its last
//   non-_INT_MAX slot.  One block-wide scan lists each row's run starts;
//   merge round r then merges runs [g 2^r, g 2^r + 2^(r-1)) with the next
//   2^(r-1) runs, ceil(log2(runs)) rounds for the tile's most divided row.
//   Each thread holds E consecutive slots in registers, finds the merge of
//   its first slot by a binary search over the row's groups and its place in
//   it by a merge-path search on the diagonal, and merges on into later
//   groups and rows; ties go to the left run, so equal columns keep their
//   slot order with the column alone as the key.  Rows of one run move not
//   at all.
// - Merge of equal columns: a run of a column starts where the column
//   changes; one block-wide scan of the starts gives each its output place,
//   the thread holding a start sums the run directly in slot order (pattern
//   mode: its length, an exact count), on into the next threads' slots while
//   the column lasts.  The merged rows, _INT_MAX / 0 past nuniq, are laid
//   out in shared memory and written back as one contiguous, 16-byte-stored
//   block.  No atomics on the outputs: the same inputs give the same bits,
//   (b) on the tables gives the bits of (c) on the slab (a) built, and both
//   give the bits of a sort on (column, slot).
// - K5: a count pass (each merged row with entries stores its count at its
//   row id), the indptr scan (torch), then one copy pass over every chunk,
//   a thread per slot of a merged row: the slots past the row's nuniq exit
//   at once, and a warp's lanes copy consecutive entries of a row (coalesced
//   loads and stores).  The same pass zeroes the CSR's padding [nnz,
//   nnz_pad) by 16-byte stores; entries at or past nnz_pad are dropped.

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

// one product's tables (ops/slab_spgemm.py: _Tables)
struct Tables {
  const int* b2_cols;   // (nseg_pad, W) B's columns, _INT_MAX pads; the last segment all pads
  const void* b2_vals;  // (nseg_pad, W) B's values (dtype b_code); null in pattern mode
  const int* pa_b2row;  // (npa_pad,) B2 segment of each pa
  const void* pa_aval;  // (npa_pad,) A value of each pa (dtype a_code); null in pattern mode
  const int* rowmeta;   // (nrow_pad, 2) [first pa, pa count] per row in class order
  long long npa_pad;
  long long last_seg;
  int a_code, b_code;
  int W;
  int vec4;  // W % 4 == 0 and the tables 16-byte aligned: the columns (and values) by 16-byte loads
};

// the fields of a launch's host chunk table, one int64 row per chunk
// (ops/slab_kernel.py: MERGE_FIELDS, COMPACT_FIELDS)
enum MergeField { kColPtr, kValPtr, kStart, kCount, kRpad, kL, kOutSlot, kOutRow, kTile0, kRowsT, kMergeFields };
enum CompactField { kRowsPtr, kColsPtr, kValsPtr, kNuPtr, kCRpad, kCL, kRow0, kSlot0, kCompactFields };

// chunks one launch takes: its chunk table travels as a kernel parameter
// (within the 4 KB a launch's parameters may hold), so a launch needs no
// device allocation and no copy
constexpr int kMaxChunks = 64;

// one chunk of a merge launch: (c) its slab, (b) its first row in rowmeta
// and its live rows (rows [count, R_pad) have no pa), where its outputs go
// (first slot of cols_u / vals_u, first row of nuniq), its first tile in the
// launch and its rows per tile
struct MergeChunk {
  const void* col;
  const void* val;
  long long out_slot;
  int start, count, R_pad, L, out_row, tile0, rows_t, pad_;
};
struct MergeTab {
  int n;
  MergeChunk c[kMaxChunks];
};

// one chunk of K5: its outputs, its first row and first slot over the
// launch's chunks
struct CompactChunk {
  const int* rows;
  const int* cols;
  const void* vals;
  const int* nu;
  long long row0, slot0;
  int R_pad, L;
};
struct CompactTab {
  int n;
  CompactChunk c[kMaxChunks];
};

// the last chunk whose first item (tile, row or piece: `first`) is <= x
template <typename Tab, typename F>
__device__ __forceinline__ int chunk_of(const Tab& tab, long long x, F first) {
  int lo = 0, hi = tab.n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first(tab.c[mid]) <= x)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// K4 (a)'s host chunk table (ops/slab_kernel.py: FETCH_FIELDS, fetch_plan):
// a chunk's first output slot (a multiple of 4), its first 16-byte piece in
// the launch, its first row in rowmeta, its live rows, R_pad, L
enum FetchField { kFOutSlot, kFPiece0, kFStart, kFCount, kFRpad, kFL, kFetchFields };

struct FetchChunk {
  long long out_slot, piece0, start;
  int count, R_pad, L, pad_;
};
struct FetchTab {
  int n;
  FetchChunk c[kMaxChunks];
};

// how K4 (a) reads the values: none (pattern), both tables in the
// accumulate type (16-byte loads), or any dtype through `widen`
enum FetchMode { kFetchPattern, kFetchSame, kFetchWiden };

constexpr int kFetchThreads = 256;
// 16-byte pieces a thread of the piece kernel takes, all loads in flight
// before its first store
constexpr int kFetchPieces = 4;

// four consecutive slots' columns and partial products by 16-byte
// streaming stores (the cache is read by a later call, not by this one)
template <typename TA>
__device__ __forceinline__ void put_piece(int* col, TA* val, long long o, int4 c, const TA (&r)[4], bool values) {
  __stcs(reinterpret_cast<int4*>(col + o), c);
  if (!values) return;
  if constexpr (sizeof(TA) == 4) {
    __stcs(reinterpret_cast<float4*>(val + o), make_float4(r[0], r[1], r[2], r[3]));
  } else {
    __stcs(reinterpret_cast<double2*>(val + o), make_double2(r[0], r[1]));
    __stcs(reinterpret_cast<double2*>(val + o + 2), make_double2(r[2], r[3]));
  }
}

// K4 (a), W % 4 == 0 and 16-byte aligned tables: thread `tid` of CTA b takes
// pieces b * U * NT + u * NT + tid (u < U), each four consecutive slots of a
// chunk's slab inside one pa block, so a warp's store covers 512 contiguous
// bytes of columns.  Every piece's loads start a level at a time --
// the row's (first pa, pa count), then the pa's B2 segment (and A value),
// then the segment's four columns (and values) -- before the first store;
// a piece of a dead block or row loads nothing.
template <typename TA, int MODE>
__global__ void __launch_bounds__(kFetchThreads) fetch_piece_kernel(Tables t, const __grid_constant__ FetchTab tab,
                                                                    long long npieces, int* __restrict__ col,
                                                                    TA* __restrict__ val) {
  constexpr int U = kFetchPieces, NT = kFetchThreads;
  constexpr bool PATTERN = MODE == kFetchPattern;
  const long long p0 = blockIdx.x * static_cast<long long>(U * NT) + threadIdx.x;
  const int W = t.W;
  long long out[U], seg[U];
  int blk[U], nb[U], base[U];
  int k = chunk_of(tab, min(p0, npieces - 1), [](const FetchChunk& c) { return c.piece0; });
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long p = p0 + u * NT;
    out[u] = -1;
    blk[u] = nb[u] = base[u] = 0;
    seg[u] = 0;
    if (p < npieces) {
      while (k + 1 < tab.n && tab.c[k + 1].piece0 <= p) ++k;
      const FetchChunk& ch = tab.c[k];
      const int local = static_cast<int>(p - ch.piece0), per_row = ch.L >> 2;
      const int i = local / per_row, e = (local - i * per_row) * 4;
      blk[u] = e / W;
      seg[u] = e - blk[u] * W;  // the piece's first slot in its block, until the segment is known
      out[u] = ch.out_slot + 4LL * local;
      if (i < ch.count) {
        const long long m = 2 * (ch.start + i);
        base[u] = __ldg(t.rowmeta + m);
        nb[u] = __ldg(t.rowmeta + m + 1);
      }
    }
  }
  TA av[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    av[u] = TA(0);
    if (blk[u] < nb[u]) {
      const long long pa = min(max(static_cast<long long>(base[u]) + blk[u], 0LL), t.npa_pad - 1);
      seg[u] += min(max(static_cast<long long>(__ldg(t.pa_b2row + pa)), 0LL), t.last_seg) * W;
      if constexpr (MODE == kFetchSame) av[u] = __ldg(static_cast<const TA*>(t.pa_aval) + pa);
      if constexpr (MODE == kFetchWiden) av[u] = widen<TA>(t.pa_aval, t.a_code, pa);
    } else {
      seg[u] = -1;
    }
  }
  int4 c[U];
  TA v[U][4];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long s = seg[u];
    c[u] = s >= 0 ? __ldg(reinterpret_cast<const int4*>(t.b2_cols + s)) : make_int4(kIntMax, kIntMax, kIntMax, kIntMax);
#pragma unroll
    for (int x = 0; x < 4; ++x) v[u][x] = TA(0);
    if (PATTERN || s < 0) continue;
    if constexpr (MODE == kFetchSame && sizeof(TA) == 4) {
      const float4 b4 = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(t.b2_vals) + s));
      v[u][0] = b4.x;
      v[u][1] = b4.y;
      v[u][2] = b4.z;
      v[u][3] = b4.w;
    } else if constexpr (MODE == kFetchSame) {
      const double2* bp = reinterpret_cast<const double2*>(static_cast<const double*>(t.b2_vals) + s);
      const double2 lo = __ldg(bp), hi = __ldg(bp + 1);
      v[u][0] = lo.x;
      v[u][1] = lo.y;
      v[u][2] = hi.x;
      v[u][3] = hi.y;
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) v[u][x] = widen<TA>(t.b2_vals, t.b_code, s + x);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (out[u] < 0) continue;
    const int4 cu = c[u];
    const TA a = av[u];
    const TA r[4] = {cu.x != kIntMax ? mul_rn(v[u][0], a) : TA(0), cu.y != kIntMax ? mul_rn(v[u][1], a) : TA(0),
                     cu.z != kIntMax ? mul_rn(v[u][2], a) : TA(0), cu.w != kIntMax ? mul_rn(v[u][3], a) : TA(0)};
    put_piece(col, val, out[u], cu, r, !PATTERN);
  }
}

// K4 (a) for any W and tables: a thread per piece of four consecutive slots
// of a chunk's flat slab (rows and blocks may change inside it), each
// slot's three loads started a level at a time for the four, then one
// 16-byte store (scalar ones for a chunk's partial last piece)
template <typename TA, int MODE>
__global__ void __launch_bounds__(kFetchThreads) fetch_slot_kernel(Tables t, const __grid_constant__ FetchTab tab,
                                                                   long long npieces, int* __restrict__ col,
                                                                   TA* __restrict__ val) {
  constexpr bool PATTERN = MODE == kFetchPattern;
  const long long p = blockIdx.x * static_cast<long long>(kFetchThreads) + threadIdx.x;
  if (p >= npieces) return;
  const FetchChunk& ch = tab.c[chunk_of(tab, p, [](const FetchChunk& c) { return c.piece0; })];
  const long long s0 = (p - ch.piece0) * 4, n = static_cast<long long>(ch.R_pad) * ch.L;
  const int W = t.W;
  long long seg[4];
  int blk[4], nb[4], base[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    blk[x] = nb[x] = base[x] = 0;
    seg[x] = 0;
    if (s0 + x < n) {
      const int i = static_cast<int>((s0 + x) / ch.L), e = static_cast<int>(s0 + x - static_cast<long long>(i) * ch.L);
      blk[x] = e / W;
      seg[x] = e - blk[x] * W;
      if (i < ch.count) {
        const long long m = 2 * (ch.start + i);
        base[x] = __ldg(t.rowmeta + m);
        nb[x] = __ldg(t.rowmeta + m + 1);
      }
    }
  }
  TA av[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    av[x] = TA(0);
    if (blk[x] < nb[x]) {
      const long long pa = min(max(static_cast<long long>(base[x]) + blk[x], 0LL), t.npa_pad - 1);
      seg[x] += min(max(static_cast<long long>(__ldg(t.pa_b2row + pa)), 0LL), t.last_seg) * W;
      if (!PATTERN) av[x] = widen<TA>(t.pa_aval, t.a_code, pa);
    } else {
      seg[x] = -1;
    }
  }
  int cc[4];
  TA v[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    cc[x] = seg[x] >= 0 ? __ldg(t.b2_cols + seg[x]) : kIntMax;
    v[x] = !PATTERN && seg[x] >= 0 ? widen<TA>(t.b2_vals, t.b_code, seg[x]) : TA(0);
  }
  TA r[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) r[x] = cc[x] != kIntMax ? mul_rn(v[x], av[x]) : TA(0);
  const long long o = ch.out_slot + s0;
  if (s0 + 4 <= n) {
    put_piece(col, val, o, make_int4(cc[0], cc[1], cc[2], cc[3]), r, !PATTERN);
    return;
  }
  for (int x = 0; x < 4 && s0 + x < n; ++x) {
    col[o + x] = cc[x];
    if (!PATTERN) val[o + x] = r[x];
  }
}

// n elements from device memory to shared memory by the CTA's NT threads:
// 16-byte loads where src is aligned, four in flight per thread
template <int NT, typename T>
__device__ __forceinline__ void stage_copy(T* __restrict__ dst, const T* __restrict__ src, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int nv = n / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int b = 0; b < nv; b += 4 * NT) {
      uint4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = b + u * NT + threadIdx.x;
        if (i < nv) r[u] = __ldg(s4 + i);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = b + u * NT + threadIdx.x;
        if (i < nv) d4[i] = r[u];
      }
    }
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < n; i += NT) dst[i] = __ldg(src + i);
}

// n elements from shared memory to device memory, 16-byte stores where dst is
// aligned
template <int NT, typename T>
__device__ __forceinline__ void unstage_copy(T* __restrict__ dst, const T* __restrict__ src, int n) {
  constexpr int V = 16 / sizeof(T);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int nv = n / V;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < nv; i += NT) d4[i] = s4[i];
    done = nv * V;
  }
  for (int i = done + threadIdx.x; i < n; i += NT) dst[i] = src[i];
}

// an exclusive block-wide scan of one count per thread; returns the thread's
// offset, and the block's total in *total.  sw: 33 ints of shared memory.
template <int NT>
__device__ __forceinline__ int block_scan(int cnt, int* sw, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += x;
  }
  if (lane == 31) sw[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NT / 32 ? sw[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += x;
    }
    sw[lane] = w;
  }
  __syncthreads();
  *total = sw[NT / 32 - 1];
  return (warp > 0 ? sw[warp - 1] : 0) + incl - cnt;
}

// E consecutive slots of shared memory to and from registers, 16-byte
// accesses (E a multiple of 4; p 16-byte aligned)
template <int E>
__device__ __forceinline__ void load_items(int (&key)[E], const int* sk, int p) {
#pragma unroll
  for (int x = 0; x < E; x += 4) {
    const int4 c = *reinterpret_cast<const int4*>(sk + p + x);
    key[x] = c.x;
    key[x + 1] = c.y;
    key[x + 2] = c.z;
    key[x + 3] = c.w;
  }
}

template <int E>
__device__ __forceinline__ void store_items(const int (&key)[E], int* sk, int p) {
#pragma unroll
  for (int x = 0; x < E; x += 4)
    *reinterpret_cast<int4*>(sk + p + x) = make_int4(key[x], key[x + 1], key[x + 2], key[x + 3]);
}

template <int E>
__device__ __forceinline__ void load_items(float (&val)[E], const float* sv, int p) {
#pragma unroll
  for (int x = 0; x < E; x += 4) {
    const float4 v = *reinterpret_cast<const float4*>(sv + p + x);
    val[x] = v.x;
    val[x + 1] = v.y;
    val[x + 2] = v.z;
    val[x + 3] = v.w;
  }
}

template <int E>
__device__ __forceinline__ void store_items(const float (&val)[E], float* sv, int p) {
#pragma unroll
  for (int x = 0; x < E; x += 4)
    *reinterpret_cast<float4*>(sv + p + x) = make_float4(val[x], val[x + 1], val[x + 2], val[x + 3]);
}

template <int E>
__device__ __forceinline__ void load_items(double (&val)[E], const double* sv, int p) {
#pragma unroll
  for (int x = 0; x < E; x += 2) {
    const double2 v = *reinterpret_cast<const double2*>(sv + p + x);
    val[x] = v.x;
    val[x + 1] = v.y;
  }
}

template <int E>
__device__ __forceinline__ void store_items(const double (&val)[E], double* sv, int p) {
#pragma unroll
  for (int x = 0; x < E; x += 2) *reinterpret_cast<double2*>(sv + p + x) = make_double2(val[x], val[x + 1]);
}

// four consecutive slots' columns and values into shared memory (o a
// multiple of 4)
template <typename TA>
__device__ __forceinline__ void put4(int* sk, TA* sv, int o, int4 c, const TA (&v)[4], bool values) {
  *reinterpret_cast<int4*>(sk + o) = c;
  if (!values) return;
  if constexpr (sizeof(TA) == 4) {
    *reinterpret_cast<float4*>(sv + o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<double2*>(sv + o) = make_double2(v[0], v[1]);
    *reinterpret_cast<double2*>(sv + o + 2) = make_double2(v[2], v[3]);
  }
}

// K4 (b) with FETCH, (c) without: one tile of rows per CTA, E consecutive
// slots per thread.  Shared memory: values (T, TA; in pattern mode only the
// output counts),
// columns (T int32), run starts (T uint16), three arrays of rows_cap + 1
// ints (live lengths; run / output bases; (b) the rows' first pa) and 33
// ints for the scans.
template <typename TA, bool PATTERN, bool FETCH, int NT, int E, int MINB>
__global__ void __launch_bounds__(NT, MINB) slab_merge_kernel(Tables t, const __grid_constant__ MergeTab tab, int rows_cap,
                                                              int* __restrict__ cols_u, TA* __restrict__ vals_u,
                                                              int* __restrict__ nuniq) {
  constexpr int T = NT * E;
  extern __shared__ __align__(16) unsigned char smem[];
  TA* sv = reinterpret_cast<TA*>(smem);
  int* sk = reinterpret_cast<int*>(smem + static_cast<size_t>(T) * sizeof(TA));
  unsigned short* rs = reinterpret_cast<unsigned short*>(sk + T);
  int* s_n = reinterpret_cast<int*>(rs + T);
  int* s_base = s_n + rows_cap + 1;
  int* s_aux = s_base + rows_cap + 1;
  int* s_w = s_aux + rows_cap + 1;  // 32 warp totals, then the tile's most runs in a row
  const int tid = threadIdx.x;

  const MergeChunk& ch = tab.c[chunk_of(tab, blockIdx.x, [](const MergeChunk& c) { return c.tile0; })];
  const int L = ch.L, R_pad = ch.R_pad, rows_t = ch.rows_t;
  const int r0 = (static_cast<int>(blockIdx.x) - ch.tile0) * rows_t;
  const int rows = min(rows_t, R_pad - r0);
  const int S = rows * L;
  const long long gout = ch.out_slot + static_cast<long long>(r0) * L;

  // 1. stage the tile: every slot's column and value, rows unpadded
  for (int r = tid; r < rows; r += NT) s_n[r] = 0;
  if (tid == 0) s_w[32] = 0;
  if (FETCH) {
    const int start = ch.start, count = ch.count;
    for (int r = tid; r < rows; r += NT) {
      const int i = r0 + r;
      const long long m = 2 * (static_cast<long long>(start) + i);
      s_aux[r] = i < count ? __ldg(t.rowmeta + m) : 0;
      s_base[r] = i < count ? __ldg(t.rowmeta + m + 1) : 0;
    }
    __syncthreads();
    const int W = t.W, nblk = L / W, nq = rows * nblk;
    for (int b = 0; b < nq; b += 4 * NT) {
      long long seg[4];
      TA av[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = b + u * NT + tid;
        seg[u] = -1;
        av[u] = TA(0);
        if (q < nq) {
          const int r = q / nblk, j = q - r * nblk;
          if (j < s_base[r]) {
            const long long pa = min(max(static_cast<long long>(s_aux[r]) + j, 0LL), t.npa_pad - 1);
            seg[u] = min(max(static_cast<long long>(__ldg(t.pa_b2row + pa)), 0LL), t.last_seg);
            if (!PATTERN) av[u] = widen<TA>(t.pa_aval, t.a_code, pa);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int q = b + u * NT + tid;
        if (q >= nq) continue;
        const int r = q / nblk, o = r * L + (q - r * nblk) * W;
        const long long sg = seg[u];
        const TA a = av[u];
        const int* cp = t.b2_cols + sg * W;
        auto value = [&](int w, int c) {
          return c != kIntMax ? mul_rn(widen<TA>(t.b2_vals, t.b_code, sg * W + w), a) : TA(0);
        };
        if (t.vec4) {  // W % 4 == 0: o too
          for (int w = 0; w < W; w += 4) {
            const int4 c4 = sg < 0 ? make_int4(kIntMax, kIntMax, kIntMax, kIntMax)
                                   : __ldg(reinterpret_cast<const int4*>(cp + w));
            TA v[4] = {TA(0), TA(0), TA(0), TA(0)};
            if (!PATTERN && sg >= 0 && t.b_code == kF32) {  // 16-byte loads of fp32 B values
              const float4 b4 = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(t.b2_vals) + sg * W + w));
              v[0] = c4.x != kIntMax ? mul_rn(static_cast<TA>(b4.x), a) : TA(0);
              v[1] = c4.y != kIntMax ? mul_rn(static_cast<TA>(b4.y), a) : TA(0);
              v[2] = c4.z != kIntMax ? mul_rn(static_cast<TA>(b4.z), a) : TA(0);
              v[3] = c4.w != kIntMax ? mul_rn(static_cast<TA>(b4.w), a) : TA(0);
            } else if (!PATTERN && sg >= 0) {
              v[0] = value(w, c4.x);
              v[1] = value(w + 1, c4.y);
              v[2] = value(w + 2, c4.z);
              v[3] = value(w + 3, c4.w);
            }
            put4(sk, sv, o + w, c4, v, !PATTERN);
          }
        } else {
          for (int w = 0; w < W; ++w) {
            const int c = sg < 0 ? kIntMax : __ldg(cp + w);
            sk[o + w] = c;
            if (!PATTERN) sv[o + w] = sg < 0 ? TA(0) : value(w, c);
          }
        }
      }
    }
  } else {
    const long long g = static_cast<long long>(r0) * L;
    stage_copy<NT>(sk, static_cast<const int*>(ch.col) + g, S);
    if (!PATTERN) stage_copy<NT>(sv, static_cast<const TA*>(ch.val) + g, S);
  }
  __syncthreads();

  // 2. the runs: a run starts at a row's first slot and below a column's
  //    predecessor; each row's live length (after its last non-pad slot);
  //    one block-wide scan lists each row's run starts in rs[row * L ...]
  const int o = tid * E;
  const int row0 = min(o, S) / L, e0 = min(o, S) - row0 * L;
  int key[E];
  TA val[E];
  if (o < S) {
    load_items(key, sk, o);
    if (!PATTERN) load_items(val, sv, o);
  } else {
#pragma unroll
    for (int x = 0; x < E; ++x) key[x] = kIntMax;
  }
  unsigned starts = 0;
  {
    int prev = e0 > 0 ? sk[o - 1] : kIntMax, row = row0, e = e0, trow = -1, tlen = 0;
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if (o + x < S) {
        if (e == 0 || key[x] < prev) starts |= 1u << x;
        if (key[x] != kIntMax) {
          if (row != trow) {
            if (trow >= 0) atomicMax(s_n + trow, tlen);
            trow = row;
          }
          tlen = e + 1;
        }
        prev = key[x];
        if (++e == L) {
          e = 0;
          ++row;
        }
      }
    }
    if (trow >= 0) atomicMax(s_n + trow, tlen);
  }
  int total;
  const int roff = block_scan<NT>(__popc(starts), s_w, &total);
  {
    int run = roff, row = row0, e = e0;
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if (o + x < S && e == 0) s_base[row] = run;
      run += (starts >> x) & 1;
      if (++e == L) {
        e = 0;
        ++row;
      }
    }
    if (tid == NT - 1) s_base[rows] = total;
  }
  __syncthreads();
  {
    int run = roff, row = row0, e = e0;
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if ((starts >> x) & 1) {
        rs[row * L + run - s_base[row]] = static_cast<unsigned short>(e);
        if (e == 0) atomicMax(s_w + 32, s_base[row + 1] - s_base[row]);
        ++run;
      }
      if (++e == L) {
        e = 0;
        ++row;
      }
    }
  }
  __syncthreads();
  const int most = s_w[32];
  const int rounds = most <= 1 ? 0 : 32 - __clz(most - 1);

  // 3. merge rounds: round r merges each row's runs [g 2^r, g 2^r + 2^(r-1))
  //    with the next 2^(r-1), stably (ties to the left); a thread's slots
  //    take their items from the merges they fall in
  for (int r = 1; r <= rounds; ++r) {
    bool moved = false;
    // the thread's slots, segment by segment: a group of the round (merged
    // or, one run alone, kept) or a row's dead tail (kept)
    for (int x0 = 0; x0 < E && o + x0 < S;) {
      const int p = o + x0, row = p / L, rb = row * L, e = p - rb, n = s_n[row];
      int end = rb + L;  // a row's dead tail stays
      if (e < n) {
        const int m = s_base[row + 1] - s_base[row];
        const unsigned short* rr = rs + rb;
        int lo = 0, hi = (m - 1) >> r;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (rr[mid << r] <= e)
            lo = mid;
          else
            hi = mid - 1;
        }
        const int i0 = lo << r, im = i0 + (1 << (r - 1)), i1 = i0 + (1 << r);
        const int gs = rr[i0], gm = im < m ? rr[im] : n, ge = i1 < m ? rr[i1] : n;
        end = rb + ge;
        if (gm < ge) {  // a merge; a group of one run stays
          const int d = e - gs, A = rb + gs, B = rb + gm;
          int a = max(0, d - (ge - gm)), ah = min(d, gm - gs);
          while (a < ah) {
            const int mid = (a + ah) >> 1;
            if (sk[B + d - 1 - mid] < sk[A + mid])
              ah = mid;
            else
              a = mid + 1;
          }
          int ia = A + a, ib = B + d - a;
          const int ea = B, eb = end, x1 = min(E, end - o);
          int ka = ia < ea ? sk[ia] : 0, kb = ib < eb ? sk[ib] : 0;
          moved = true;
#pragma unroll
          for (int x = 0; x < E; ++x) {
            if (x >= x0 && x < x1) {
              if (ib < eb && (ia >= ea || kb < ka)) {
                key[x] = kb;
                if (!PATTERN) val[x] = sv[ib];
                ++ib;
                kb = ib < eb ? sk[ib] : 0;
              } else {
                key[x] = ka;
                if (!PATTERN) val[x] = sv[ia];
                ++ia;
                ka = ia < ea ? sk[ia] : 0;
              }
            }
          }
        }
      }
      x0 = min(E, end - o);
    }
    __syncthreads();
    if (moved) {
      store_items(key, sk, o);
      if (!PATTERN) store_items(val, sv, o);
    }
    __syncthreads();
  }

  // 4. runs of equal columns: a start where the column changes (or a row
  //    begins), one block-wide scan of the starts, each row's output base
  unsigned ust = 0;
  {
    int prev = e0 > 0 ? sk[o - 1] : kIntMax, row = row0, e = e0;
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if (o + x < S && key[x] != kIntMax && (e == 0 || key[x] != prev)) ust |= 1u << x;
      prev = key[x];
      if (++e == L) {
        e = 0;
        ++row;
      }
    }
  }
  const int uoff = block_scan<NT>(__popc(ust), s_w, &total);
  {
    int run = uoff, row = row0, e = e0;
#pragma unroll
    for (int x = 0; x < E; ++x) {
      if (o + x < S && e == 0) s_base[row] = run;
      run += (ust >> x) & 1;
      if (++e == L) {
        e = 0;
        ++row;
      }
    }
    if (tid == NT - 1) s_base[rows] = total;
  }

  // 5. each run summed in slot order by the thread holding its start, the sum
  //    kept in the register of the run's last slot in the thread (uend); the
  //    last open run followed on into the next threads' slots
  unsigned uend = 0;
  {
    bool open = false;
    int cc = 0, orow = 0, row = row0, e = e0;
    TA sum = TA(0);
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const TA v = PATTERN ? TA(1) : val[x];
      if ((ust >> x) & 1) {
        if (open && x > 0) {
          val[x - 1] = sum;
          uend |= 1u << (x - 1);
        }
        open = true;
        cc = key[x];
        orow = row;
        sum = v;
      } else if (open && key[x] == cc && o + x < S) {
        sum = sum + v;
      } else if (open) {
        if (x > 0) {
          val[x - 1] = sum;
          uend |= 1u << (x - 1);
        }
        open = false;
      }
      if (++e == L) {
        e = 0;
        ++row;
      }
    }
    if (open) {
      const int end = orow * L + L;
      for (int q = o + E; q < end && sk[q] == cc; ++q) sum = sum + (PATTERN ? TA(1) : sv[q]);
      val[E - 1] = sum;
      uend |= 1u << (E - 1);
    }
  }
  __syncthreads();

  // 6. the merged rows laid out in shared memory, _INT_MAX / 0 past nuniq,
  //    then written back as one block; nuniq per row
  {
    int run = uoff, row = row0, e = e0;
#pragma unroll
    for (int x = 0; x < E; ++x) {
      const int p = o + x;
      run += (ust >> x) & 1;
      if (p < S) {
        const int rb = row * L;
        if ((uend >> x) & 1) {
          const int q = rb + run - 1 - s_base[row];
          sk[q] = key[x];
          sv[q] = val[x];
        }
        if (e >= s_base[row + 1] - s_base[row]) {
          sk[p] = kIntMax;
          sv[p] = TA(0);
        }
      }
      if (++e == L) {
        e = 0;
        ++row;
      }
    }
  }
  __syncthreads();
  unstage_copy<NT>(cols_u + gout, sk, S);
  unstage_copy<NT>(vals_u + gout, sv, S);
  const long long orow = static_cast<long long>(ch.out_row) + r0;
  for (int r = tid; r < rows; r += NT) nuniq[orow + r] = s_base[r + 1] - s_base[r];
}

// K5's count pass: each chunk row g with entries stores its nuniq at its row
// id (a chunk's padded rows repeat other rows' ids with nuniq 0)
__global__ void slab_count_kernel(const __grid_constant__ CompactTab tab, long long rtot, long long nrow, int* __restrict__ counts) {
  for (long long g = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; g < rtot;
       g += static_cast<long long>(gridDim.x) * blockDim.x) {
    const CompactChunk& ch = tab.c[chunk_of(tab, g, [](const CompactChunk& c) { return c.row0; })];
    const long long i = g - ch.row0;
    const int nu = __ldg(ch.nu + i);
    const long long r = __ldg(ch.rows + i);
    if (nu > 0 && r >= 0 && r < nrow) counts[r] = nu;
  }
}

// K5's copy pass: a thread per slot of a merged row, the slots below the
// row's nuniq copied to indptr[row id] on (a warp's lanes take consecutive
// slots: coalesced loads and stores); then, with `tail`, the CSR's padding
// [nnz, nnz_pad) zeroed by 16-byte stores
template <typename TA>
__global__ void slab_compact_kernel(const __grid_constant__ CompactTab tab, long long stot,
                                    const long long* __restrict__ indptr, long long nrow, long long nnz_pad, int tail,
                                    TA* __restrict__ data, int* __restrict__ indices) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  for (long long b = t0 - lane; b < stot; b += stride) {  // b: the warp's first slot, the same in every lane
    // the warp's chunk, looked up once by lane 0; a lane past its end looks
    // up its own
    int c = lane == 0 ? chunk_of(tab, b, [](const CompactChunk& x) { return x.slot0; }) : 0;
    c = __shfl_sync(0xffffffffu, c, 0);
    const long long q = b + lane;
    if (q >= stot) continue;
    if (q >= tab.c[c].slot0 + static_cast<long long>(tab.c[c].R_pad) * tab.c[c].L)
      c = chunk_of(tab, q, [](const CompactChunk& x) { return x.slot0; });
    const CompactChunk& ch = tab.c[c];
    const int local = static_cast<int>(q - ch.slot0), i = local / ch.L, e = local - i * ch.L;
    if (e >= __ldg(ch.nu + i)) continue;
    const long long r = __ldg(ch.rows + i);
    if (r < 0 || r >= nrow) continue;
    const long long d = __ldg(indptr + r) + e;
    if (d < nnz_pad) {
      indices[d] = __ldg(ch.cols + local);
      data[d] = __ldg(static_cast<const TA*>(ch.vals) + local);
    }
  }
  if (!tail) return;
  const long long nnz = __ldg(indptr + nrow);
  const long long a = min(nnz_pad, (nnz + 3) & ~3LL), b = max(a, nnz_pad & ~3LL);
  if (t0 < a - nnz) {
    indices[nnz + t0] = 0;
    data[nnz + t0] = TA(0);
  }
  for (long long q = a + 4 * t0; q < b; q += 4 * stride) {
    *reinterpret_cast<int4*>(indices + q) = make_int4(0, 0, 0, 0);
    if constexpr (sizeof(TA) == 4) {
      *reinterpret_cast<float4*>(data + q) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
      *reinterpret_cast<double2*>(data + q) = make_double2(0., 0.);
      *reinterpret_cast<double2*>(data + q + 2) = make_double2(0., 0.);
    }
  }
  if (t0 < nnz_pad - b) {
    indices[b + t0] = 0;
    data[b + t0] = TA(0);
  }
}

Tables make_tables(const void* b2_cols, const void* b2_vals, int b_code, const void* pa_b2row,
                   const void* pa_aval, int a_code, const void* rowmeta, long long npa_pad,
                   long long nseg_pad, int W, int vec4) {
  Tables t;
  t.b2_cols = static_cast<const int*>(b2_cols);
  t.b2_vals = b2_vals;
  t.pa_b2row = static_cast<const int*>(pa_b2row);
  t.pa_aval = pa_aval;
  t.rowmeta = static_cast<const int*>(rowmeta);
  t.npa_pad = npa_pad;
  t.last_seg = nseg_pad - 1;
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

// a host chunk table (int64 rows of MergeField) as a launch parameter
bool merge_tab(const long long* rows, int n, MergeTab* tab) {
  if (n <= 0 || n > kMaxChunks) return false;
  tab->n = n;
  for (int k = 0; k < n; ++k) {
    const long long* r = rows + static_cast<long long>(k) * kMergeFields;
    MergeChunk& c = tab->c[k];
    c.col = reinterpret_cast<const void*>(r[kColPtr]);
    c.val = reinterpret_cast<const void*>(r[kValPtr]);
    c.out_slot = r[kOutSlot];
    c.start = static_cast<int>(r[kStart]);
    c.count = static_cast<int>(r[kCount]);
    c.R_pad = static_cast<int>(r[kRpad]);
    c.L = static_cast<int>(r[kL]);
    c.out_row = static_cast<int>(r[kOutRow]);
    c.tile0 = static_cast<int>(r[kTile0]);
    c.rows_t = static_cast<int>(r[kRowsT]);
    c.pad_ = 0;
    if (c.L <= 0 || c.R_pad <= 0 || c.rows_t <= 0) return false;
  }
  return true;
}

bool compact_tab(const long long* rows, int n, CompactTab* tab) {
  if (n < 0 || n > kMaxChunks) return false;
  tab->n = n;
  for (int k = 0; k < n; ++k) {
    const long long* r = rows + static_cast<long long>(k) * kCompactFields;
    CompactChunk& c = tab->c[k];
    c.rows = reinterpret_cast<const int*>(r[kRowsPtr]);
    c.cols = reinterpret_cast<const int*>(r[kColsPtr]);
    c.vals = reinterpret_cast<const void*>(r[kValsPtr]);
    c.nu = reinterpret_cast<const int*>(r[kNuPtr]);
    c.R_pad = static_cast<int>(r[kCRpad]);
    c.L = static_cast<int>(r[kCL]);
    c.row0 = r[kRow0];
    c.slot0 = r[kSlot0];
    if (c.L <= 0 || c.R_pad <= 0) return false;
  }
  return true;
}

// K4 (a)'s host chunk table (int64 rows of FetchField) as a launch
// parameter; with vec4 each chunk's rows are whole pieces (L % 4 == 0) and
// its first slot is 16-byte aligned
bool fetch_tab(const long long* rows, int n, int W, int vec4, long long npieces, FetchTab* tab) {
  if (n <= 0 || n > kMaxChunks) return false;
  tab->n = n;
  long long pieces = 0;
  for (int k = 0; k < n; ++k) {
    const long long* r = rows + static_cast<long long>(k) * kFetchFields;
    FetchChunk& c = tab->c[k];
    c.out_slot = r[kFOutSlot];
    c.piece0 = r[kFPiece0];
    c.start = r[kFStart];
    c.count = static_cast<int>(r[kFCount]);
    c.R_pad = static_cast<int>(r[kFRpad]);
    c.L = static_cast<int>(r[kFL]);
    c.pad_ = 0;
    if (c.L <= 0 || c.R_pad <= 0 || c.L % W != 0 || c.count < 0 || c.count > c.R_pad || c.start < 0 ||
        c.out_slot % 4 != 0 || c.piece0 != pieces || (vec4 && c.L % 4 != 0)) {
      return false;
    }
    const long long own = (static_cast<long long>(c.R_pad) * c.L + 3) / 4;
    if (own > 0x7fffffffLL) return false;  // a chunk's pieces are counted in int
    pieces += own;
  }
  return pieces == npieces;
}

template <typename TA, int MODE>
cudaError_t launch_fetch(const Tables& t, const FetchTab& tab, long long npieces, void* col, void* val,
                         cudaStream_t s) {
  int* c = static_cast<int*>(col);
  TA* v = static_cast<TA*>(val);
  if (t.vec4) {
    const long long per = static_cast<long long>(kFetchPieces) * kFetchThreads;
    fetch_piece_kernel<TA, MODE><<<static_cast<unsigned>((npieces + per - 1) / per), kFetchThreads, 0, s>>>(
        t, tab, npieces, c, v);
  } else if constexpr (MODE != kFetchSame) {
    fetch_slot_kernel<TA, MODE><<<static_cast<unsigned>((npieces + kFetchThreads - 1) / kFetchThreads),
                                  kFetchThreads, 0, s>>>(t, tab, npieces, c, v);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the merge's block sizes (ops/slab_kernel.py: MERGE_GROUPS), each at 64
// registers a thread: 256 threads of 8 slots for rows of up to 2,048 slots
// (four CTAs an SM, whose barriers overlap), 512 of 8 up to 4,096, 1,024 of
// 16 above
template <typename TA, bool PATTERN, bool FETCH>
cudaError_t launch_merge(int group, const Tables& t, const MergeTab& tab, int tiles, int rows_cap, long long smem,
                         void* cols_u, void* vals_u, void* nuniq, cudaStream_t s) {
  auto run = [&](auto kern, int nt) {
    if (smem > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    kern<<<static_cast<unsigned>(tiles), nt, static_cast<size_t>(smem), s>>>(
        t, tab, rows_cap, static_cast<int*>(cols_u), static_cast<TA*>(vals_u), static_cast<int*>(nuniq));
    return cudaGetLastError();
  };
  if (group == 0) return run(slab_merge_kernel<TA, PATTERN, FETCH, 256, 8, 4>, 256);
  if (group == 1) return run(slab_merge_kernel<TA, PATTERN, FETCH, 512, 8, 2>, 512);
  return run(slab_merge_kernel<TA, PATTERN, FETCH, 1024, 16, 1>, 1024);
}

template <bool FETCH>
int merge_entry(const Tables& t, const void* tab_rows, int nchunks, int tiles, int group, int rows_cap,
                long long smem, int acc_code, int pattern, void* cols_u, void* vals_u, void* nuniq, cudaStream_t s) {
  MergeTab tab;
  if (tiles <= 0 || rows_cap <= 0 || group < 0 || group > 2 || smem > 232448 || (FETCH && t.W <= 0) ||
      !merge_tab(static_cast<const long long*>(tab_rows), nchunks, &tab)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err;
  if (acc_code == kF32)
    err = pattern ? launch_merge<float, true, FETCH>(group, t, tab, tiles, rows_cap, smem, cols_u, vals_u, nuniq, s)
                  : launch_merge<float, false, FETCH>(group, t, tab, tiles, rows_cap, smem, cols_u, vals_u, nuniq,
                                                      s);
  else if (acc_code == kF64)
    err = pattern ? launch_merge<double, true, FETCH>(group, t, tab, tiles, rows_cap, smem, cols_u, vals_u, nuniq,
                                                      s)
                  : launch_merge<double, false, FETCH>(group, t, tab, tiles, rows_cap, smem, cols_u, vals_u, nuniq,
                                                       s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace
}  // namespace spmm_tpu_torch

// The tables of one product (int32 b2_cols (nseg_pad, W), pa_b2row (npa_pad,),
// rowmeta (nrow_pad, 2); b2_vals / pa_aval of dtypes b_code / a_code, null in
// pattern mode; all contiguous).  acc_code: float32 or float64.

// K4 (a): the slabs of up to 64 chunks in one launch.  tab: the host chunk
// table (nchunks, 6) int64 (ops/slab_kernel.py: fetch_plan), passed to the
// kernel as a parameter, its chunks' npieces pieces of 4 slots; chunk k's
// rows [start, start + R_pad) of rowmeta, of which the first `count` are
// live, L slots each, go to col (int32) and, unless pattern, val (acc) at
// its out_slot.  col and val 16-byte aligned.  vec4: W % 4 == 0 and the
// tables 16-byte aligned (the piece kernel; the slot kernel otherwise).
extern "C" int slab_fetch_launch(const void* b2_cols, const void* b2_vals, int b_code, const void* pa_b2row,
                                 const void* pa_aval, int a_code, const void* rowmeta, long long npa_pad,
                                 long long nseg_pad, int W, int vec4, const void* tab, int nchunks,
                                 long long npieces, int acc_code, int pattern, void* col, void* val, void* stream) {
  using namespace spmm_tpu_torch;
  FetchTab tb;
  if (W <= 0 || npa_pad <= 0 || nseg_pad <= 0 || npieces <= 0 || (vec4 && W % 4 != 0) ||
      (reinterpret_cast<uintptr_t>(col) & 15) || (!pattern && (reinterpret_cast<uintptr_t>(val) & 15)) ||
      (!pattern && (!value_code(a_code) || !value_code(b_code))) ||
      !fetch_tab(static_cast<const long long*>(tab), nchunks, W, vec4, npieces, &tb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables t = make_tables(b2_cols, b2_vals, b_code, pa_b2row, pa_aval, a_code, rowmeta, npa_pad, nseg_pad, W,
                               vec4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool same = vec4 && a_code == acc_code && b_code == acc_code;
  cudaError_t err;
  if (acc_code == kF32)
    err = pattern ? launch_fetch<float, kFetchPattern>(t, tb, npieces, col, val, s)
          : same  ? launch_fetch<float, kFetchSame>(t, tb, npieces, col, val, s)
                  : launch_fetch<float, kFetchWiden>(t, tb, npieces, col, val, s);
  else if (acc_code == kF64)
    err = pattern ? launch_fetch<double, kFetchPattern>(t, tb, npieces, col, val, s)
          : same  ? launch_fetch<double, kFetchSame>(t, tb, npieces, col, val, s)
                  : launch_fetch<double, kFetchWiden>(t, tb, npieces, col, val, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// K4 (b) and (c): one launch over up to 64 chunks of one block-size group.
// tab: the host chunk table (nchunks, 10) int64 (ops/slab_kernel.py:
// merge_plan), passed to the kernel as a parameter; tiles CTAs of the group's
// size (group 0 rows of up to 4,096 slots, 1 wider); rows_cap: the most rows
// a tile holds; smem: bytes of dynamic shared memory.  With b2_cols (b): the
// chunks' rows fetched from the tables; with it null (c): each chunk's slab
// read at its kColPtr / kValPtr.  Outputs cols_u and vals_u (the chunks'
// (R_pad, L) slabs, in acc) and nuniq (the chunks' rows), at each chunk's
// kOutSlot / kOutRow.
extern "C" int slab_merge_launch(const void* b2_cols, const void* b2_vals, int b_code, const void* pa_b2row,
                                 const void* pa_aval, int a_code, const void* rowmeta, long long npa_pad,
                                 long long nseg_pad, int W, int vec4, const void* tab, int nchunks, int tiles,
                                 int group, int rows_cap, long long smem, int acc_code, int pattern, void* cols_u,
                                 void* vals_u, void* nuniq, void* stream) {
  using namespace spmm_tpu_torch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b2_cols == nullptr) {
    Tables t{};
    return merge_entry<false>(t, tab, nchunks, tiles, group, rows_cap, smem, acc_code, pattern, cols_u, vals_u,
                              nuniq, s);
  }
  if (npa_pad <= 0 || nseg_pad <= 0 || (!pattern && (!value_code(a_code) || !value_code(b_code)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Tables t =
      make_tables(b2_cols, b2_vals, b_code, pa_b2row, pa_aval, a_code, rowmeta, npa_pad, nseg_pad, W, vec4);
  return merge_entry<true>(t, tab, nchunks, tiles, group, rows_cap, smem, acc_code, pattern, cols_u, vals_u, nuniq,
                           s);
}

// K5's count pass over up to 64 chunks: tab the host chunk table (nchunks, 8)
// int64 (ops/slab_kernel.py: compact_plan) of rtot chunk rows; counts (nrow,)
// int32, zero where no row stores.
extern "C" int slab_compact_counts_launch(const void* tab, int nchunks, long long rtot, long long nrow,
                                          void* counts, void* stream) {
  using namespace spmm_tpu_torch;
  CompactTab tb;
  if (rtot < 0 || nrow < 0 || !compact_tab(static_cast<const long long*>(tab), nchunks, &tb) ||
      (rtot > 0 && nchunks == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rtot == 0 || nrow == 0) return 0;
  slab_count_kernel<<<grid_of(rtot, 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(tb, rtot, nrow,
                                                                                       static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// K5's copy pass over the stot slots of up to 64 chunks' merged rows into
// the CSR arrays data (nnz_pad,) in acc and indices (nnz_pad,) int32 at
// indptr (nrow + 1,) int64; with `tail`, data and indices past indptr[nrow]
// zeroed.
extern "C" int slab_compact_launch(const void* tab, int nchunks, long long stot, const void* indptr,
                                   long long nrow, long long nnz_pad, int tail, int acc_code, void* data,
                                   void* indices, void* stream) {
  using namespace spmm_tpu_torch;
  CompactTab tb;
  if (stot < 0 || nrow < 0 || nnz_pad < 0 || !compact_tab(static_cast<const long long*>(tab), nchunks, &tb) ||
      (stot > 0 && nchunks == 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nnz_pad == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_of(std::max(stot, tail ? nnz_pad / 4 : 0LL), 256);
  const long long* ip = static_cast<const long long*>(indptr);
  int* ind = static_cast<int*>(indices);
  if (acc_code == kF32)
    slab_compact_kernel<float><<<grid, 256, 0, s>>>(tb, stot, ip, nrow, nnz_pad, tail, static_cast<float*>(data),
                                                    ind);
  else if (acc_code == kF64)
    slab_compact_kernel<double><<<grid, 256, 0, s>>>(tb, stot, ip, nrow, nnz_pad, tail,
                                                     static_cast<double*>(data), ind);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
