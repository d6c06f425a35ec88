// Ordered segment sum: out[s, :] = sum over positions i in [offsets[s],
// offsets[s+1]) of data[row(i), :], row(i) = order[i] (or i itself when the
// ids were sorted), summed in an order fixed by the shapes and the offsets
// alone -- the same bits on every run, no atomics on values.
//
// No TPU kernel: it replaces the XLA segment sums of the JAX package
// (jax.ops.segment_sum, e.g. spmm_tpu/ops/spmm.py: spmm_xla), which the port
// first wrote as torch's index_add_ -- atomic adds on CUDA, whose order, and
// so whose rounding, changes from run to run (ROADMAP F6).
//
// What bounds it on this card: bytes.  Each data row is read once and each
// output row written once (one add per element read).  What kept the first
// design (one CTA per segment) from that was a segment far longer than the
// rest: a web graph's hub rows (75 segments of PageRank's leftover stream hold
// 1.37M rows at k = 1, the longest 345,617) were walked by one SM each while
// the other SMs sat idle.
//
// Design: the work is cut by POSITIONS, not by segments.
// - The positions [0, N) are cut into chunks of P rows, one CTA each (per
//   column tile of at most 128 columns); P = G * IPT is chosen on the host
//   from k and the dtype alone (ops/segments.py: chunk_layout), so that a
//   chunk is 32 KB, 64 KB where a row fills a warp.  Every segment's rows,
//   however long, are spread over the chunks they lie in: no SM walks more
//   than a chunk.
// - A CTA stages its chunk in shared memory with its loads in flight (16-byte
//   vectors where the rows are contiguous and aligned: at k = 1 one load
//   covers 4 fp32 rows, heads and tails masked; through order[] when the ids
//   were unsorted; where a row fills a warp, by cp.async from warps 2..7,
//   with no registers held), while warp 0 finds the segment of the chunk's
//   first row by a 32-way search and copies a window of the offsets from it
//   on to shared memory.  Then its G lane groups of CT lanes (one column per
//   lane and 32-lane step) each walk IPT consecutive rows in order, finding
//   their segments by galloping over that window (empty segments are
//   skipped, not walked): the walk's chain of dependent offset loads costs
//   shared-memory latency, not L2's.  A segment wholly inside a group is
//   written straight to out.
// - Pieces of segments that cross group boundaries are joined by a segmented
//   scan over the groups in shared memory (log2(G) steps, one barrier each, a
//   fixed tree): a group that a segment passes through carries it on, any
//   other starts afresh; the group where a segment ends adds its piece to the
//   carry.  A segment that crosses the chunk's end leaves one partial per
//   chunk in scratch (its head in partB, its piece in each later chunk in
//   partA); a second launch (seg_fixup_kernel, one warp per chunk, only when
//   there is more than one chunk) adds them in chunk order, the chunks
//   strided over the warp's lane rows and joined by a fixed butterfly, and
//   zeroes the empty segments (warp-wide, coalesced).
// - The grid, (ceil(N / P), ceil(k / 128)), and the order of every sum follow
//   from N, k and the dtype alone; the call needs no host sync and at most
//   two launches.

#include <algorithm>

#include "common.cuh"

namespace spmm_tpu_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kStageLoads = 8;  // staging loads in flight per thread
constexpr unsigned kIn = 1;     // the group's first segment began before it
constexpr unsigned kEnds = 2;   // ... and ends inside it
constexpr unsigned kOut = 4;    // a segment that begins in the group leaves it
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOffWindow = 512;  // offsets a CTA keeps in shared memory for its walk

// padded shared-memory index: one spare element per 128 bytes, so that the
// groups' strided walks hit distinct banks
template <typename T>
__host__ __device__ __forceinline__ int padx(int x) {
  return x + (x >> (sizeof(T) == 8 ? 4 : 5));
}

// elements of one stage of x elements: padded, and a whole number of 16-byte
// units so that the second stage stays aligned for cp.async
template <typename T>
__host__ __device__ __forceinline__ int stage_size(long long x) {
  const int e = padx<T>(static_cast<int>(x) - 1) + 1;
  constexpr int u = 16 / sizeof(T);
  return (e + u - 1) / u * u;
}

// the last s in (lo, hi) with off(s) <= x, or lo; needs off(lo) <= x (or lo
// == -1) and off(hi) > x (or hi one past the end)
template <typename F>
__device__ __forceinline__ long long last_le(F off, long long lo, long long hi, long long x) {
  while (hi - lo > 1) {
    const long long mid = lo + (hi - lo) / 2;
    if (off(mid) <= x) lo = mid; else hi = mid;
  }
  return lo;
}

// the last s in [0, nseg] with off[s] <= x (-1 if none): a 32-way search by
// the whole warp, ~log32(nseg) rounds of one load per lane
__device__ long long warp_last_le(const long long* off, long long nseg, long long x) {
  const int lane = threadIdx.x & 31;
  long long lo = -1, hi = nseg + 1;
  while (hi - lo > 1) {
    const long long idx = lo + 1 + ((hi - lo - 2) * lane) / 31;  // lo+1 .. hi-1, sorted by lane
    const unsigned m = __ballot_sync(kFull, off[idx] <= x);
    const int c = __popc(m);
    const long long a = __shfl_sync(kFull, idx, c > 0 ? c - 1 : 0);
    const long long b = __shfl_sync(kFull, idx, c < 32 ? c : 31);
    if (c > 0) lo = a;
    if (c < 32) hi = b;
  }
  return lo;
}

// the last s' >= s with off(s') <= p, given off(s) <= p: galloping, one load
// when the next segment is not empty
template <typename F>
__device__ __forceinline__ long long gallop(F off, long long s, long long nseg, long long p) {
  long long step = 1;
  for (;;) {
    const long long t = s + step;
    if (t > nseg || off(t) > p) return last_le(off, s, t > nseg ? nseg + 1 : t, p);
    s = t;
    step <<= 1;
  }
}

// asynchronous copies to shared memory (cp.async: no registers held while
// they fly), and the wait for all of this thread's
template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(gmem));
  } else {
    static_assert(BYTES == 8, "8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(a), "l"(gmem));
  }
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

template <typename T, int VEC>
__device__ __forceinline__ void ld_vec(const T* p, T* v) {
  if constexpr (VEC * sizeof(T) == 16) {
    const int4 u = __ldg(reinterpret_cast<const int4*>(p));
    const T* w = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int q = 0; q < VEC; ++q) v[q] = w[q];
  } else {
    static_assert(VEC == 1, "16-byte vectors or scalars");
    v[0] = __ldg(p);
  }
}

// out's rows of the empty segments: zeros, this tile's columns.  Each lane
// of a warp checks one segment (grid-stride over the warps), then the warp
// writes the empty ones' rows one by one, its lanes on adjacent columns.
template <typename T>
__device__ __forceinline__ void zero_empty(const long long* __restrict__ offsets, T* __restrict__ out,
                                           long long nseg, long long k, int col0, int ktl) {
  const int lane = threadIdx.x & 31;
  const long long warp = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long nwarps = (static_cast<long long>(gridDim.x) * kThreads) >> 5;
  for (long long s0 = warp * 32; s0 < nseg; s0 += nwarps * 32) {
    const long long s = s0 + lane;
    unsigned m = __ballot_sync(kFull, s < nseg && offsets[s] == offsets[s + 1]);
    while (m) {
      const int j = __ffs(m) - 1;
      m &= m - 1;
      for (int col = lane; col < ktl; col += 32) out[(s0 + j) * k + col0 + col] = T(0);
    }
  }
}

// One CTA per (chunk, column tile).  NC: columns per lane (kt / ct rounded
// up to 1, 2 or 4); VEC: elements per staging load; ORDER: rows through
// order.  segB null: N fits one chunk and no fix-up follows (this kernel then
// zeroes the empty segments itself).
template <typename T, int VEC, int NC, bool ORDER>
__global__ void __launch_bounds__(kThreads)
seg_chunk_kernel(const T* __restrict__ data, const long long* __restrict__ offsets,
                 const long long* __restrict__ order, T* __restrict__ out, T* __restrict__ partA,
                 T* __restrict__ partB, long long* __restrict__ segB, long long n, long long nseg,
                 long long k, int kt, int ct_log2, int ipt, int flat) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sh = reinterpret_cast<T*>(smem_raw);
  __shared__ long long first_seg;         // the segment of the chunk's first row
  __shared__ long long soff[kOffWindow];  // offsets[first_seg ..], as far as they fit
  __shared__ unsigned fl[2 * kThreads];

  const int ct = 1 << ct_log2;
  const int G = kThreads >> ct_log2;
  const long long P = static_cast<long long>(G) * ipt;
  const long long c = blockIdx.x;
  const long long p0 = c * P, p1 = min(p0 + P, n);
  const int col0 = blockIdx.y * kt;
  const int ktl = static_cast<int>(min(static_cast<long long>(kt), k - col0));  // live columns
  const int g = threadIdx.x >> ct_log2, l = threadIdx.x & (ct - 1);
  // a row that fills a warp is read by one warp at a time: no bank conflicts
  // to pad against, and its 16-byte units go to shared memory by cp.async
  const bool wide = ct == 32;
  const bool async = VEC * sizeof(T) == 16 && wide;
  auto sidx = [&](int x) { return wide ? x : padx<T>(x); };

  if (segB == nullptr) zero_empty(offsets, out, nseg, k, col0, ktl);
  if (p1 <= p0) return;  // no rows at all (N == 0)

  // stage the chunk, row r of the tile at sh[sidx(r * kt + column)]; its
  // loads (by warps 2..7 and cp.async for wide rows, a first round of loads
  // into registers otherwise) go out while warp 0 searches the segment of
  // the chunk's first row (a 32-way search) and copies the offsets' window
  const int rows = static_cast<int>(p1 - p0);
  const int units = ktl / VEC;  // per row (the host takes VEC > 1 only when k % VEC == 0 or flat)
  const int cnt = flat ? rows * kt / VEC : rows * units;
  auto unit_src = [&](int t) -> const T* {
    if (flat) return data + p0 * k + static_cast<long long>(t) * VEC;  // one run of rows * k
    const int r = t / units, u = t - r * units;
    const long long row = ORDER ? order[p0 + r] : p0 + r;
    return data + row * k + col0 + u * VEC;
  };
  auto unit_dst = [&](int t) { return flat ? t * VEC : (t / units) * kt + (t % units) * VEC; };
  auto search = [&]() {
    if (threadIdx.x < 32) {
      const long long s = warp_last_le(offsets, nseg, p0);
      const long long ob = max(s, 0LL);
      const int on = static_cast<int>(min(static_cast<long long>(kOffWindow), nseg + 1 - ob));
      for (int j = threadIdx.x; j < on; j += 32) cp_async<8>(soff + j, offsets + ob + j);
      if (threadIdx.x == 0) first_seg = s;
    }
  };
  if constexpr (VEC * sizeof(T) == 16) {
    if (async && threadIdx.x >= 64) {
      for (int t = threadIdx.x - 64; t < cnt; t += kThreads - 64) cp_async<16>(sh + unit_dst(t), unit_src(t));
    }
  }
  for (int t0 = threadIdx.x, first = 1; first || (!async && t0 < cnt);
       t0 += kStageLoads * kThreads, first = 0) {
    T v[kStageLoads][VEC];
    if (!async) {
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        if (t0 + j * kThreads < cnt) ld_vec<T, VEC>(unit_src(t0 + j * kThreads), v[j]);
      }
    }
    if (first) search();
    if (!async) {
#pragma unroll
      for (int j = 0; j < kStageLoads; ++j) {
        const int t = t0 + j * kThreads;
        if (t < cnt) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) sh[sidx(unit_dst(t) + q)] = v[j][q];
        }
      }
    }
  }
  if (flat) {  // the run's tail past its last whole vector
    const T* src = data + p0 * k;
    for (int x = cnt * VEC + threadIdx.x; x < rows * kt; x += kThreads) sh[sidx(x)] = src[x];
  }
  cp_async_wait_all();
  __syncthreads();
  const long long br0 = first_seg;
  const long long ob = max(br0, 0LL);
  const long long on = min(static_cast<long long>(kOffWindow), nseg + 1 - ob);
  auto off = [&](long long i) { return i >= ob && i < ob + on ? soff[i - ob] : offsets[i]; };
  const int glast = static_cast<int>((p1 - 1 - p0) / ipt);

  // the walk: group g takes rows [a, b) in order
  const long long a = p0 + static_cast<long long>(g) * ipt;
  const long long b = min(a + ipt, p1);
  T ip[NC], cp[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) ip[q] = cp[q] = T(0);
  unsigned f = 0;
  long long is = -1, cs = -1;
  if (a < b) {
    long long s = -1, p = a;
    if (br0 >= 0 || a >= off(0)) {
      s = gallop(off, max(br0, 0LL), nseg, a);
    } else {  // rows before the first segment take no part
      p = off(0);
      if (p < b) s = gallop(off, 0, nseg, p);
    }
    while (s >= 0 && s < nseg && p < b) {
      const long long lo = off(s), hi = off(s + 1);
      const long long e = min(hi, b);
      T acc[NC];
#pragma unroll
      for (int q = 0; q < NC; ++q) acc[q] = T(0);
      for (int i = static_cast<int>(p - p0); i < static_cast<int>(e - p0); ++i) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int col = l + q * ct;
          if (col < ktl) acc[q] += sh[sidx(i * kt + col)];
        }
      }
      if (lo < a) {  // entered from the group before
        f |= kIn | (hi <= b ? kEnds : 0u);
        is = s;
#pragma unroll
        for (int q = 0; q < NC; ++q) ip[q] = acc[q];
      } else if (hi > b) {  // leaves for the group after
        f |= kOut;
        cs = s;
#pragma unroll
        for (int q = 0; q < NC; ++q) cp[q] = acc[q];
      } else {  // wholly in this group
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int col = l + q * ct;
          if (col < ktl) out[s * k + col0 + col] = acc[q];
        }
      }
      if (hi >= b) break;
      p = hi;
      s = gallop(off, s + 1, nseg, p);
    }
  }

  // The pieces of segments that cross groups, joined by a segmented scan
  // over the groups (Hillis-Steele: log2(G) steps, a fixed tree): a group
  // that a segment passes through carries it on, adding its piece; any other
  // starts afresh with the piece of the segment that leaves it (or nothing).
  // After it, group g holds carry_g and whether a fresh start lies in groups
  // 0..g.
  const bool thr = (f & (kIn | kEnds)) == kIn;
  T v[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) v[q] = thr ? ip[q] : ((f & kOut) ? cp[q] : T(0));
  unsigned rf = thr ? 0u : 1u;
  __syncthreads();  // the stage is read: it now holds the scan, in two buffers taken in turn
  T* buf[2] = {sh, sh + G * kt};
  int d = 0;
  for (;; ++d) {
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = l + q * ct;
      if (col < kt) buf[d & 1][g * kt + col] = v[q];
    }
    if (l == 0) fl[(d & 1) * kThreads + g] = rf;
    __syncthreads();
    if ((1 << d) == G) break;  // the last pass only publishes
    const int gp = g - (1 << d);
    if (gp >= 0) {
      if (!rf) {
#pragma unroll
        for (int q = 0; q < NC; ++q) {
          const int col = l + q * ct;
          if (col < kt) v[q] = buf[d & 1][gp * kt + col] + v[q];
        }
      }
      rf |= fl[(d & 1) * kThreads + gp];
    }
  }
  const T* carry = buf[d & 1];
  const unsigned* fresh = fl + (d & 1) * kThreads;
  // (1) a segment that entered group g from before ends in it: carry_{g-1}
  // plus its piece here, to out when it began in this chunk
  if ((f & kIn) && (f & kEnds)) {
    const bool began = g > 0 && fresh[g - 1];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int col = l + q * ct;
      if (col >= ktl) continue;
      const T tot = g > 0 ? carry[(g - 1) * kt + col] + ip[q] : ip[q];
      if (began) out[is * k + col0 + col] = tot;
      else partA[c * k + col0 + col] = tot;  // began in an earlier chunk
    }
  }
  // (2) the segment that leaves the chunk at its end: its head (partB), or
  // the whole chunk's piece of a segment that passes through it (partA)
  if (segB != nullptr && g == glast) {
    long long sb = -1;
    if ((f & kOut) || thr) {
#pragma unroll
      for (int q = 0; q < NC; ++q) {
        const int col = l + q * ct;
        if (col < ktl) (rf ? partB : partA)[c * k + col0 + col] = v[q];
      }
      if (rf) sb = (f & kOut) ? cs : is;
    }
    if (l == 0 && blockIdx.y == 0) segB[c] = sb;
  }
}

// One warp per chunk (grid-stride over the chunks): the segment whose head
// chunk c0 holds gets B[c0] + A[c0 + 1] + ... + A[c1], the chunks strided
// over the warp's W = 32 / cf lane rows and their sums joined by a fixed
// butterfly.  First, a grid-stride pass zeroes the empty segments.
template <typename T>
__global__ void __launch_bounds__(kThreads)
seg_fixup_kernel(const long long* __restrict__ offsets, const T* __restrict__ partA,
                 const T* __restrict__ partB, const long long* __restrict__ segB,
                 T* __restrict__ out, long long nseg, long long nchunks, long long k, int kt,
                 long long P, int cf_log2) {
  const int col0 = blockIdx.y * kt;
  const int ktl = static_cast<int>(min(static_cast<long long>(kt), k - col0));
  zero_empty(offsets, out, nseg, k, col0, ktl);
  const int cf = 1 << cf_log2, W = 32 >> cf_log2;
  const int lane = threadIdx.x & 31;
  const int cl = lane & (cf - 1), part = lane >> cf_log2;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long c0 = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32; c0 < nchunks;
       c0 += warps) {
    const long long s = segB[c0];
    if (s < 0) continue;  // whole warps
    const long long c1 = (offsets[s + 1] - 1) / P;
    for (int cb = 0; cb < ktl; cb += cf) {
      const int col = col0 + cb + cl;
      T acc = T(0);
      if (cb + cl < ktl) {
        for (long long cc = c0 + 1 + part; cc <= c1; cc += W) acc += partA[cc * k + col];
      }
      for (int o = 16; o >= cf; o >>= 1) acc += __shfl_xor_sync(kFull, acc, o);
      if (part == 0 && cb + cl < ktl) out[s * k + col] = partB[c0 * k + col] + acc;
    }
  }
}

template <typename T, int VEC, int NC, bool ORDER>
cudaError_t launch_chunks(const T* d, const long long* off, const long long* ord, T* o, T* pA, T* pB,
                          long long* sB, long long n, long long nseg, long long k, int kt, int ct_log2,
                          int ipt, int flat, long long nchunks, unsigned tiles, size_t smem,
                          cudaStream_t s) {
  auto kern = seg_chunk_kernel<T, VEC, NC, ORDER>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(static_cast<unsigned>(nchunks), tiles), kThreads, smem, s>>>(
      d, off, ord, o, pA, pB, sB, n, nseg, k, kt, ct_log2, ipt, flat);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* d, const long long* off, const long long* ord, T* o, T* pA, T* pB,
                       long long* sB, long long n, long long nseg, long long k, int kt, int ct_log2,
                       int ipt, int flat, long long nchunks, unsigned tiles, size_t smem,
                       cudaStream_t s) {
  const int nc = (kt + (1 << ct_log2) - 1) >> ct_log2;
#define SPMM_TPU_TORCH_SEG(NC)                                                                    \
  return ord ? launch_chunks<T, VEC, NC, true>(d, off, ord, o, pA, pB, sB, n, nseg, k, kt, ct_log2, \
                                               ipt, flat, nchunks, tiles, smem, s)                 \
             : launch_chunks<T, VEC, NC, false>(d, off, ord, o, pA, pB, sB, n, nseg, k, kt, ct_log2, \
                                                ipt, flat, nchunks, tiles, smem, s)
  if (nc == 1) SPMM_TPU_TORCH_SEG(1);
  if (nc == 2) SPMM_TPU_TORCH_SEG(2);
  if (nc <= 4) SPMM_TPU_TORCH_SEG(4);
#undef SPMM_TPU_TORCH_SEG
  return cudaErrorInvalidValue;
}

template <typename T, int VECW>
cudaError_t launch(const void* data, const long long* off, const long long* ord, void* out,
                   void* scratch, long long n, long long nseg, long long k, int vec, int kt,
                   int ct_log2, int ipt, cudaStream_t s) {
  const long long P = static_cast<long long>(kThreads >> ct_log2) * ipt;
  const long long nchunks = n > 0 ? (n + P - 1) / P : 1;
  const long long tiles = (k + kt - 1) / kt;
  if (nchunks > 0x7fffffffLL || tiles > 65535) return cudaErrorInvalidValue;
  const int flat = !ord && tiles == 1;
  if (vec > 1 && !flat && k % vec != 0) return cudaErrorInvalidValue;
  // the stage, padded; it later holds the scan's two buffers (2 * G * kt <= P * kt)
  const size_t smem = static_cast<size_t>(stage_size<T>(P * kt)) * sizeof(T);
  if (smem > 100 * 1024 || ipt < 2) return cudaErrorInvalidValue;
  // scratch (nchunks > 1): segB (nchunks int64), then partA and partB (nchunks, k) each
  long long* sB = nchunks > 1 ? static_cast<long long*>(scratch) : nullptr;
  T* pA = nchunks > 1 ? reinterpret_cast<T*>(sB + nchunks) : nullptr;
  T* pB = nchunks > 1 ? pA + nchunks * k : nullptr;
  const T* d = static_cast<const T*>(data);
  T* o = static_cast<T*>(out);
  cudaError_t err;
  if (vec == VECW)
    err = launch_vec<T, VECW>(d, off, ord, o, pA, pB, sB, n, nseg, k, kt, ct_log2, ipt, flat, nchunks,
                              static_cast<unsigned>(tiles), smem, s);
  else if (vec == 1)
    err = launch_vec<T, 1>(d, off, ord, o, pA, pB, sB, n, nseg, k, kt, ct_log2, ipt, flat, nchunks,
                           static_cast<unsigned>(tiles), smem, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess || nchunks == 1) return err;
  int cf_log2 = 0;
  while ((1 << cf_log2) < std::min(kt, 32)) ++cf_log2;
  const long long warps_needed = (nchunks + kThreads / 32 - 1) / (kThreads / 32);
  const unsigned fix_ctas = static_cast<unsigned>(std::min(warps_needed, 2048LL));
  seg_fixup_kernel<T><<<dim3(fix_ctas, static_cast<unsigned>(tiles)), kThreads, 0, s>>>(
      off, pA, pB, sB, o, nseg, nchunks, k, kt, P, cf_log2);
  return cudaGetLastError();
}

}  // namespace
}  // namespace spmm_tpu_torch

// data (N, k) and out (nseg, k) of one dtype (float32, float64, int32, int64),
// contiguous; offsets (nseg + 1,) int64 sorted, offsets[nseg] <= N; order (N,)
// int64 or null.  The layout (ops/segments.py: chunk_layout): kt columns per
// tile (at most 128), 2**ct_log2 lanes per row, ipt rows per lane group.
// vec: 16 / sizeof(dtype) when data is 16-byte aligned and either the rows are
// read as one run (no order, k <= kt) or k % vec == 0; else 1.  scratch: the
// wrapper's buffer of nchunks * (8 + 2 * k * sizeof(dtype)) bytes, unused (and
// may be null) when N fits one chunk.  Two launches when it does not.
extern "C" int segment_sum_launch(const void* data, const void* offsets, const void* order,
                                  void* out, void* scratch, int dtype, long long n, long long nseg,
                                  long long k, int vec, int kt, int ct_log2, int ipt, void* stream) {
  using namespace spmm_tpu_torch;
  if (nseg <= 0 || k <= 0) return 0;
  if (ct_log2 < 0 || ct_log2 > 5 || vec < 1 || kt < 1 || kt > 128 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec > 1 && reinterpret_cast<uintptr_t>(data) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long* off = static_cast<const long long*>(offsets);
  const long long* ord = static_cast<const long long*>(order);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32)
    err = launch<float, 4>(data, off, ord, out, scratch, n, nseg, k, vec, kt, ct_log2, ipt, s);
  else if (dtype == kF64)
    err = launch<double, 2>(data, off, ord, out, scratch, n, nseg, k, vec, kt, ct_log2, ipt, s);
  else if (dtype == kI32)
    err = launch<int, 4>(data, off, ord, out, scratch, n, nseg, k, vec, kt, ct_log2, ipt, s);
  else if (dtype == kI64)
    err = launch<long long, 2>(data, off, ord, out, scratch, n, nseg, k, vec, kt, ct_log2, ipt, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
