// Stage A of the mesh's distributed wide group-by (parallel/dist.py
// `dist_wide_groupby`, entered through `shard_partials`): one shard's
// partial groups, placed straight into its send buffers, from the
// shard's codes sorted alone.
//
// Replaces no TPU kernel. The TPU package computes stage A with jnp under
// jax.jit (rayforce_tpu/parallel/dist.py `dist_wide_groupby`), where XLA
// fuses the elementwise work; eager PyTorch ran it as ~40 launches, each a
// pass over the shard's rows (2.5e8 a card on a 1e9-row table over four
// cards): the row position packed into an i64 sort key, the lane
// gathers, the run flags, two compactions, the row iota, the segment
// ids, scatters of nearly every row to dropped slots and the send
// buckets' hit matrix.
//
// The sort key is the code alone, masked rows (code < 0) at a sentinel
// past every code: one i32 word where the code space is known and below
// 2^31 - 1 (sentinel n_codes), else the i64 code as psort's pair of
// words (the signed high i32, the low i32 with its sign bit flipped;
// sentinel KEY_MAX). The radix sort is stable, so its permutation is
// each sorted row's position and no position rides the key.
//
//   keys    the codes (i64, any stride) -> the sort words; where two to
//           SP_ROW_LANES lanes are scanned, also those lanes side by side,
//           a row of 2 or 4 slots (16 or 32 bytes) a shard row;
//   lanes   the scanned lanes gathered through the sort's permutation,
//           each into its column of the block the segmented scan reads:
//           a lane at a time, or a whole side-by-side row at a time;
//   runs    three launches over the sorted key: per chunk of SP_CHUNK
//           rows the runs that start in it by bucket (code % n_dev) and
//           its segment-id increments (`counts`); their exclusive
//           offsets, a block a bucket (`offsets`); then the segment ids
//           (cumsum of run heads plus masked rows) and, for each run of
//           rank r < D among its bucket's runs in code order, its first
//           and last sorted row at slot bucket * D + r (`spans`);
//   place   the send buffers, a thread a slot: code, row count, first
//           and last global row id, each lane's value (its scanned total
//           at the run's first row, or the lane at the first or last
//           row's origin) or, in a slot no run took, the fill.
//
// Every value is the plain version's (parallel/dist.py
// `shard_partials_plain`, the torch formulas), bit for bit: the lanes
// travel as their 64-bit patterns.
//
// Bound: memory. keys reads the codes and writes the words once; counts
// and spans read the sorted key once each and spans writes the segment
// ids; lanes reads the permutation and each row at random and writes it
// once. A random 8-byte read costs a whole 32-byte sector, so with two to
// four scanned lanes keys lays them side by side first (a coalesced pass,
// 16 or 32 bytes a row) and lanes fetches a row's lanes in one sector
// (on an H100, q5's three lanes at 2.5e8 rows took 34.8 ms read one by
// one, where one lane took 9.1 ms); offsets and place
// touch per-chunk counts and the n_dev * D slots, not the n rows. In
// counts and spans a warp takes a chunk, SP_UNROLL steps of 32 rows
// loaded together so that each lane has SP_UNROLL loads in flight; the
// ranks of a step's runs within their buckets come from warp ballots,
// one round a bucket present in the step, and the warp's running count
// of each bucket sits in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define SP_THREADS 256
#define SP_WARPS (SP_THREADS / 32)
#define SP_ROWS 4
#define SP_UNROLL 4
#define SP_CHUNK 4096
#define SP_SCAN_THREADS 1024
#define SP_MAX_DEV 1024
#define SP_MAX_LANES 32
#define SP_ROW_LANES 4          // the most lanes laid side by side

typedef unsigned long long u64;

// the kernels' names read shard_partials::... in a profile
namespace shard_partials {

constexpr unsigned FULL = 0xffffffffu;
constexpr u64 KEY_MAX_WORDS = 0x7FFFFFFF7FFFFFFFull;   // KEY_MAX as words
constexpr long long KEY_MAX = 0x7FFFFFFFFFFFFFFFll;

struct RunParams {
  int64_t n;
  const int32_t* hi;       // the sorted key's (first) word
  const int32_t* lo;       // its low word; null: the key is one word
  int32_t sentinel;        // one word: the masked rows' key
  int32_t n_dev;
  int64_t n_chunks;
  int64_t D;
  int32_t* counts;         // (n_dev + 1) x n_chunks, bucket-major
  int32_t* seg;            // null: not written
  int32_t* hrow;
  int32_t* erow;
};

struct KeysParams {
  int64_t n;
  const long long* codes;
  int64_t stride;
  int wide;
  int32_t sentinel;
  int32_t* hi;
  int32_t* lo;
  int n_lanes;             // lanes laid side by side (0: none)
  int width;               // slots a row (2 or 4)
  u64* rows;
  const u64* src[SP_ROW_LANES];
  int64_t src_stride[SP_ROW_LANES];
};

struct LanesParams {
  int64_t n;
  int n_lanes;
  int width;               // > 0: src[0] is the side-by-side rows, lane l
                           // at slot l of a row of `width`
  const int32_t* perm;
  const u64* src[SP_MAX_LANES];
  int64_t src_stride[SP_MAX_LANES];
  u64* dst[SP_MAX_LANES];
  int64_t dst_stride[SP_MAX_LANES];
};

struct Lane {
  const u64* src;
  int64_t stride;          // elements a row (0: one value for all)
  u64 fill;                // a slot no run took (the f64 fill's bits)
  u64* dst;
  int32_t at;              // 0 the run's first sorted row, 1 its origin,
  int32_t pad;             // 2 the last sorted row's origin
};

struct PlaceParams {
  int64_t size, D, base;
  int n_dev, n_lanes;
  const int32_t* totals;
  const int32_t* hrow;
  const int32_t* erow;
  const int32_t* hi;
  const int32_t* lo;
  const int32_t* perm;
  long long* code;         // null: not written (a later batch of lanes)
  long long* count;
  long long* first;
  long long* last;         // null: no last lane
  Lane lane[SP_MAX_LANES];
};

__device__ __forceinline__ int64_t row(int r) {
  return (int64_t)blockIdx.x * (SP_THREADS * SP_ROWS) + threadIdx.x +
         (int64_t)r * SP_THREADS;
}

// the sorted key of row i as one 64-bit pattern: equal keys, equal
// patterns
__device__ __forceinline__ u64 key_at(const RunParams& p, int64_t i) {
  const u64 h = (uint32_t)p.hi[i];
  return p.lo ? (h << 32) | (uint32_t)p.lo[i] : h;
}

__device__ __forceinline__ bool valid(const RunParams& p, u64 k) {
  return p.lo ? k != KEY_MAX_WORDS : (uint32_t)k != (uint32_t)p.sentinel;
}

// code % n_dev of a valid row (the code is >= 0)
__device__ __forceinline__ int bucket(const RunParams& p, u64 k) {
  if (!p.lo) return (int)((uint32_t)k % (uint32_t)p.n_dev);
  const u64 code = (k & 0xFFFFFFFF00000000ull) | ((uint32_t)k ^ 0x80000000u);
  return (int)(code % (u64)p.n_dev);
}

// Chunk c's rows, a step of 32 rows at a time in row order, row
// base + lane on each lane: fn(i, in, head, end, inc, bk), called by the
// whole warp, with in (i < n), head (a valid row whose key differs from
// the row above), end (a valid row whose key differs from the row
// below), inc (head or a masked row: the segment id's increment) and bk
// (the row's bucket where head or end, else -1).
template <typename F>
__device__ __forceinline__ void walk(const RunParams& p, int64_t c, int lane,
                                     F&& fn) {
  const int64_t c0 = c * SP_CHUNK;
  const int64_t c1 = c0 + SP_CHUNK < p.n ? c0 + SP_CHUNK : p.n;
  u64 above = c0 > 0 ? key_at(p, c0 - 1) : 0;
  for (int64_t g = c0; g < c1; g += 32 * SP_UNROLL) {
    u64 k[SP_UNROLL];
#pragma unroll
    for (int s = 0; s < SP_UNROLL; ++s) {
      const int64_t i = g + s * 32 + lane;
      k[s] = i < c1 ? key_at(p, i) : 0;
    }
    const int64_t gn = g + 32 * SP_UNROLL;
    const u64 below = gn < p.n ? key_at(p, gn) : 0;
#pragma unroll
    for (int s = 0; s < SP_UNROLL; ++s) {
      const int64_t i = g + s * 32 + lane;
      u64 prv = __shfl_up_sync(FULL, k[s], 1);
      const u64 top = s ? __shfl_sync(FULL, k[s ? s - 1 : 0], 31) : above;
      if (lane == 0) prv = top;
      u64 nxt = __shfl_down_sync(FULL, k[s], 1);
      const u64 bot = s + 1 < SP_UNROLL
                          ? __shfl_sync(FULL, k[s + 1 < SP_UNROLL ? s + 1 : s], 0)
                          : below;
      if (lane == 31) nxt = bot;
      const bool in = i < c1;
      const bool v = in && valid(p, k[s]);
      const bool head = v && (i == 0 || k[s] != prv);
      const bool end = v && (i == p.n - 1 || k[s] != nxt);
      fn(i, in, head, end, head || (in && !v),
         head || end ? bucket(p, k[s]) : -1);
    }
    above = __shfl_sync(FULL, k[SP_UNROLL - 1], 31);
  }
}

__global__ void __launch_bounds__(SP_THREADS)
counts(const __grid_constant__ RunParams p) {
  extern __shared__ int32_t s_run[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * SP_WARPS + warp;
  if (c >= p.n_chunks) return;
  int32_t* run = s_run + warp * p.n_dev;
  for (int b = lane; b < p.n_dev; b += 32) run[b] = 0;
  __syncwarp();
  int32_t incs = 0;
  walk(p, c, lane, [&](int64_t, bool, bool head, bool, bool inc, int bk) {
    incs += __popc(__ballot_sync(FULL, inc));
    unsigned hm = __ballot_sync(FULL, head);
    while (hm) {
      const int b = __shfl_sync(FULL, bk, __ffs(hm) - 1);
      const unsigned m = __ballot_sync(FULL, head && bk == b);
      if (lane == 0) run[b] += __popc(m);
      hm &= ~m;
    }
  });
  __syncwarp();
  for (int b = lane; b < p.n_dev; b += 32)
    p.counts[(int64_t)b * p.n_chunks + c] = run[b];
  if (lane == 0) p.counts[(int64_t)p.n_dev * p.n_chunks + c] = incs;
}

// each row of counts (a bucket's, then the increments') made exclusive
// offsets in place, a block a row; totals[row] its sum
__global__ void __launch_bounds__(SP_SCAN_THREADS)
offsets(int32_t* counts, int64_t n_chunks, int32_t* totals) {
  __shared__ int32_t s_warp[SP_SCAN_THREADS / 32];
  int32_t* r = counts + (int64_t)blockIdx.x * n_chunks;
  const int64_t per = (n_chunks + SP_SCAN_THREADS - 1) / SP_SCAN_THREADS;
  const int64_t a0 = (int64_t)threadIdx.x * per;
  const int64_t a = a0 < n_chunks ? a0 : n_chunks;
  const int64_t e = a + per < n_chunks ? a + per : n_chunks;
  int32_t sum = 0;
  for (int64_t j = a; j < e; ++j) sum += r[j];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int32_t y = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = s_warp[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(FULL, w, d);
      if (lane >= d) w += y;
    }
    s_warp[lane] = w;
  }
  __syncthreads();
  int32_t run = x - sum + (warp ? s_warp[warp - 1] : 0);
  for (int64_t j = a; j < e; ++j) {
    const int32_t v = r[j];
    r[j] = run;
    run += v;
  }
  if (threadIdx.x == SP_SCAN_THREADS - 1) totals[blockIdx.x] = run;
}

__global__ void __launch_bounds__(SP_THREADS)
spans(const __grid_constant__ RunParams p) {
  extern __shared__ int32_t s_run[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t c = (int64_t)blockIdx.x * SP_WARPS + warp;
  if (c >= p.n_chunks) return;
  int32_t* run = s_run + warp * p.n_dev;
  for (int b = lane; b < p.n_dev; b += 32)
    run[b] = p.counts[(int64_t)b * p.n_chunks + c];
  int32_t seg = p.counts[(int64_t)p.n_dev * p.n_chunks + c];
  __syncwarp();
  const unsigned le = FULL >> (31 - lane);     // lanes 0 .. lane
  walk(p, c, lane,
       [&](int64_t i, bool in, bool head, bool end, bool inc, int bk) {
    const unsigned im = __ballot_sync(FULL, inc);
    if (p.seg != nullptr && in) p.seg[i] = seg + __popc(im & le);
    seg += __popc(im);
    const unsigned hm = __ballot_sync(FULL, head);
    unsigned am = __ballot_sync(FULL, head || end);
    while (am) {
      const int b = __shfl_sync(FULL, bk, __ffs(am) - 1);
      const unsigned mb = __ballot_sync(FULL, bk == b);
      const unsigned hb = mb & hm;
      if (bk == b) {
        // the run's rank: its bucket's heads up to this row, less one
        const int64_t r = (int64_t)run[b] + __popc(hb & le) - 1;
        if (r < p.D) {
          const int64_t slot = (int64_t)b * p.D + r;
          if (head) p.hrow[slot] = (int32_t)i;
          if (end) p.erow[slot] = (int32_t)i;
        }
      }
      __syncwarp();
      if (lane == 0) run[b] += __popc(hb);
      __syncwarp();
      am &= ~mb;
    }
  });
}

__global__ void __launch_bounds__(SP_THREADS)
keys(const __grid_constant__ KeysParams p) {
#pragma unroll
  for (int r = 0; r < SP_ROWS; ++r) {
    const int64_t i = row(r);
    if (i >= p.n) continue;
    const long long c = p.codes[i * p.stride];
    if (p.wide) {
      const u64 v = c >= 0 ? (u64)c : (u64)KEY_MAX;
      p.hi[i] = (int32_t)(uint32_t)(v >> 32);
      p.lo[i] = (int32_t)((uint32_t)v ^ 0x80000000u);
    } else {
      p.hi[i] = c >= 0 ? (int32_t)c : p.sentinel;
    }
  }
  if (p.n_lanes == 0) return;
  // the side-by-side rows, a 16-byte store at a time
#pragma unroll
  for (int r = 0; r < SP_ROWS; ++r) {
    const int64_t i = row(r);
    if (i >= p.n) continue;
    u64 v[SP_ROW_LANES] = {0, 0, 0, 0};
    for (int l = 0; l < p.n_lanes; ++l) v[l] = p.src[l][i * p.src_stride[l]];
    ulonglong2* out = (ulonglong2*)(p.rows + i * p.width);
    out[0] = make_ulonglong2(v[0], v[1]);
    if (p.width == 4) out[1] = make_ulonglong2(v[2], v[3]);
  }
}

__global__ void __launch_bounds__(SP_THREADS)
lanes(const __grid_constant__ LanesParams p) {
  int64_t at[SP_ROWS];
#pragma unroll
  for (int r = 0; r < SP_ROWS; ++r) {
    const int64_t i = row(r);
    at[r] = i < p.n ? (int64_t)p.perm[i] : -1;
  }
  if (p.width > 0) {
    // a row's lanes from one sector of the side-by-side rows
    ulonglong2 v[SP_ROWS][2];
#pragma unroll
    for (int r = 0; r < SP_ROWS; ++r) {
      v[r][1] = make_ulonglong2(0, 0);
      if (at[r] < 0) continue;
      const ulonglong2* in = (const ulonglong2*)(p.src[0] + at[r] * p.width);
      v[r][0] = in[0];
      if (p.width == 4) v[r][1] = in[1];
    }
#pragma unroll
    for (int r = 0; r < SP_ROWS; ++r) {
      if (at[r] < 0) continue;
      const int64_t i = row(r);
      const u64 x[4] = {v[r][0].x, v[r][0].y, v[r][1].x, v[r][1].y};
#pragma unroll
      for (int l = 0; l < SP_ROW_LANES; ++l)
        if (l < p.n_lanes) p.dst[l][i * p.dst_stride[l]] = x[l];
    }
    return;
  }
  for (int l = 0; l < p.n_lanes; ++l) {
    const u64* src = p.src[l];
    const int64_t ss = p.src_stride[l];
    u64 v[SP_ROWS];
#pragma unroll
    for (int r = 0; r < SP_ROWS; ++r) v[r] = at[r] >= 0 ? src[at[r] * ss] : 0;
    u64* dst = p.dst[l];
    const int64_t ds = p.dst_stride[l];
#pragma unroll
    for (int r = 0; r < SP_ROWS; ++r) {
      const int64_t i = row(r);
      if (i < p.n) dst[i * ds] = v[r];
    }
  }
}

__global__ void __launch_bounds__(SP_THREADS)
place(const __grid_constant__ PlaceParams p) {
#pragma unroll
  for (int r = 0; r < SP_ROWS; ++r) {
    const int64_t s = row(r);
    if (s >= p.size) continue;
    const int b = (int)(s / p.D);
    const bool live = s - (int64_t)b * p.D < (int64_t)p.totals[b];
    const int64_t h = live ? p.hrow[s] : 0;
    const int64_t e = live ? p.erow[s] : 0;
    if (p.code != nullptr) {
      long long code = -1;
      if (live)
        code = p.lo ? (long long)(((u64)(uint32_t)p.hi[h] << 32) |
                                  ((uint32_t)p.lo[h] ^ 0x80000000u))
                    : (long long)p.hi[h];
      p.code[s] = code;
      p.count[s] = live ? (long long)(e - h + 1) : 0;
      p.first[s] = live ? (long long)p.perm[h] + p.base : KEY_MAX;
    }
    if (p.last != nullptr)
      p.last[s] = live ? (long long)p.perm[e] + p.base : -1;
    for (int l = 0; l < p.n_lanes; ++l) {
      const Lane& ln = p.lane[l];
      u64 v = ln.fill;
      if (live) {
        const int64_t at = ln.at == 0 ? h : (int64_t)p.perm[ln.at == 1 ? h : e];
        v = ln.src[at * ln.stride];
      }
      ln.dst[s] = v;
    }
  }
}

static unsigned grid(int64_t n) {
  return (unsigned)((n + SP_THREADS * SP_ROWS - 1) / (SP_THREADS * SP_ROWS));
}

}  // namespace shard_partials

using namespace shard_partials;

// The sort words of n codes (i64, row r at r * stride elements): wide 0,
// one word, codes[r] or `sentinel` where codes[r] < 0 (the codes lie below
// 2^31 - 1); wide 1, the pair (hi, lo) of codes[r] or KEY_MAX. With
// n_lanes of 2 to SP_ROW_LANES lanes (src[l], row r at r * src_stride[l]
// elements): rows[r * width + l] = src[l]'s row r as its 64-bit pattern,
// width 2 or 4 (at least n_lanes), the slots past n_lanes 0; rows 16-byte
// aligned. n_lanes 0: no rows. One launch; returns 0 or its cudaError;
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int rf_shard_partials_keys(int64_t n, const void* codes,
                                      int64_t stride, int wide,
                                      int sentinel, void* hi, void* lo,
                                      int n_lanes, const void* const* src,
                                      const int64_t* src_stride, int width,
                                      void* rows, void* stream) {
  if (n < 0 || n >= (1LL << 31) - 1 || (wide && lo == nullptr) ||
      n_lanes < 0 || n_lanes > SP_ROW_LANES || n_lanes == 1 ||
      (n_lanes && (width < n_lanes || (width != 2 && width != 4) ||
                   ((uintptr_t)rows & 15))))
    return (int)cudaErrorInvalidValue;
  KeysParams p = {};
  p.n = n;
  p.codes = (const long long*)codes;
  p.stride = stride;
  p.wide = wide;
  p.sentinel = sentinel;
  p.hi = (int32_t*)hi;
  p.lo = (int32_t*)lo;
  p.n_lanes = n_lanes;
  p.width = width;
  p.rows = (u64*)rows;
  for (int l = 0; l < n_lanes; ++l) {
    p.src[l] = (const u64*)src[l];
    p.src_stride[l] = src_stride[l];
  }
  if (n == 0) return 0;
  keys<<<grid(n), SP_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// dst[l][i * dst_stride[l]] = src[l][perm[i] * src_stride[l]] for the n
// sorted rows, each lane's 64-bit patterns; with width > 0, src[0] is
// keys' side-by-side rows and dst[l][i * dst_stride[l]] = src[0][perm[i] *
// width + l] (n_lanes <= width). One launch; returns 0 or its cudaError;
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int rf_shard_partials_lanes(int64_t n, const void* perm,
                                       int n_lanes, const void* const* src,
                                       const int64_t* src_stride, int width,
                                       void* const* dst,
                                       const int64_t* dst_stride,
                                       void* stream) {
  if (n < 0 || n >= (1LL << 31) - 1 || n_lanes < 0 ||
      n_lanes > SP_MAX_LANES ||
      (width && (n_lanes > width || (width != 2 && width != 4) ||
                 ((uintptr_t)src[0] & 15))))
    return (int)cudaErrorInvalidValue;
  LanesParams p = {};
  p.n = n;
  p.n_lanes = n_lanes;
  p.width = width;
  p.perm = (const int32_t*)perm;
  for (int l = 0; l < n_lanes; ++l) {
    p.src[l] = (const u64*)src[width ? 0 : l];
    p.src_stride[l] = width ? 0 : src_stride[l];
    p.dst[l] = (u64*)dst[l];
    p.dst_stride[l] = dst_stride[l];
  }
  if (n == 0 || n_lanes == 0) return 0;
  lanes<<<grid(n), SP_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The runs of n sorted rows (hi, and lo for a two-word key; one word:
// masked rows at `sentinel`) over n_dev buckets of D slots. counts: the
// (n_dev + 1) * ceil(n / SP_CHUNK) i32 scratch; totals: (n_dev + 1) i32,
// each bucket's runs and the last segment id; seg (null: not written):
// (n,) i32 segment ids; hrow, erow: (n_dev * D,) i32, a run's first and
// last sorted row at its slot (other slots left as they were). Three
// launches; returns 0 or the first cudaError; cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int rf_shard_partials_runs(int64_t n, const void* hi,
                                      const void* lo, int sentinel,
                                      int n_dev, int64_t D, void* counts,
                                      void* totals, void* seg, void* hrow,
                                      void* erow, void* stream) {
  if (n < 0 || n >= (1LL << 31) - 1 || n_dev < 1 || n_dev > SP_MAX_DEV ||
      D < 1)
    return (int)cudaErrorInvalidValue;
  RunParams p = {};
  p.n = n;
  p.hi = (const int32_t*)hi;
  p.lo = (const int32_t*)lo;
  p.sentinel = sentinel;
  p.n_dev = n_dev;
  p.n_chunks = (n + SP_CHUNK - 1) / SP_CHUNK;
  p.D = D;
  p.counts = (int32_t*)counts;
  p.seg = (int32_t*)seg;
  p.hrow = (int32_t*)hrow;
  p.erow = (int32_t*)erow;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)((p.n_chunks + SP_WARPS - 1) / SP_WARPS);
  const size_t smem = (size_t)SP_WARPS * n_dev * sizeof(int32_t);
  if (blocks) {
    shard_partials::counts<<<blocks, SP_THREADS, smem, st>>>(p);
    const int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  offsets<<<n_dev + 1, SP_SCAN_THREADS, 0, st>>>(p.counts, p.n_chunks,
                                                 (int32_t*)totals);
  int rc = (int)cudaGetLastError();
  if (rc || !blocks) return rc;
  spans<<<blocks, SP_THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

// The send buffers' size = n_dev * D slots: slot s of bucket s / D holds
// a run where s % D < totals[bucket], found at hrow[s] and erow[s] among
// the sorted key's rows (hi, lo: as for runs) and the permutation perm.
// code, count, first (perm[first row] + base) and last (perm[last row] +
// base; null: not written) are i64, -1, 0, KEY_MAX and -1 in a slot
// without a run; code, count and first null: none of the three written.
// Lane l: src[l] at row (at[l] 0: the first sorted row; 1: perm of it;
// 2: perm of the last) * stride[l], else fill[l], as 64-bit patterns into
// dst[l]. One launch; returns 0 or its cudaError; cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int rf_shard_partials_place(
    int64_t size, int64_t D, int n_dev, int64_t base, const void* totals,
    const void* hrow, const void* erow, const void* hi, const void* lo,
    const void* perm, void* code, void* count, void* first, void* last,
    int n_lanes, const void* const* src, const int64_t* stride,
    const int* at, const double* fill, void* const* dst, void* stream) {
  if (size < 0 || D < 1 || n_dev < 1 || size != (int64_t)n_dev * D ||
      n_lanes < 0 || n_lanes > SP_MAX_LANES ||
      (code == nullptr) != (count == nullptr) ||
      (code == nullptr) != (first == nullptr))
    return (int)cudaErrorInvalidValue;
  PlaceParams p = {};
  p.size = size;
  p.D = D;
  p.base = base;
  p.n_dev = n_dev;
  p.n_lanes = n_lanes;
  p.totals = (const int32_t*)totals;
  p.hrow = (const int32_t*)hrow;
  p.erow = (const int32_t*)erow;
  p.hi = (const int32_t*)hi;
  p.lo = (const int32_t*)lo;
  p.perm = (const int32_t*)perm;
  p.code = (long long*)code;
  p.count = (long long*)count;
  p.first = (long long*)first;
  p.last = (long long*)last;
  for (int l = 0; l < n_lanes; ++l) {
    if (at[l] < 0 || at[l] > 2) return (int)cudaErrorInvalidValue;
    Lane& ln = p.lane[l];
    ln.src = (const u64*)src[l];
    ln.stride = stride[l];
    ln.at = at[l];
    union { double d; u64 u; } f;
    f.d = fill[l];
    ln.fill = f.u;
    ln.dst = (u64*)dst[l];
  }
  if (size == 0) return 0;
  place<<<grid(size), SP_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
