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
//   reduce  each run's scanned lanes totalled straight through the sort's
//           permutation, a warp a 1024-row block, every lane with its own
//           op in one launch (`reduce`, or `reduce_rows` for lanes side
//           by side): the in-block total of each run's first sorted row
//           (its head), each block's tail and summary word;
//   carry   the total of a head whose run reaches into earlier blocks:
//           the chain of those blocks' tails (two launches, `carry` and,
//           for chains over SP_CHAIN blocks, `chains`);
//   runs    three launches over the sorted key: per chunk of SP_CHUNK
//           rows the runs that start in it by bucket (code % n_dev) and
//           its segment-id increments (`counts`); their exclusive
//           offsets, a block a bucket (`offsets`); then, where asked, the
//           segment ids (cumsum of run heads plus masked rows) and, for
//           each run of rank r < D among its bucket's runs in code order,
//           its first and last sorted row at slot bucket * D + r
//           (`spans`);
//   place   the send buffers, a thread a slot: code, row count, first
//           and last global row id, each lane's value (its total at the
//           run's head, or the lane at the first or last row's origin)
//           or, in a slot no run took, the fill.
//
// Every value is the plain version's (parallel/dist.py
// `shard_partials_plain`, the torch formulas), bit for bit: the lanes
// travel as their 64-bit patterns. The plain version totals a run by the
// segmented scan's reversed layout (engine/groupby.py `seg_scan_plain` of
// the flipped rows, 1024-row blocks aligned from the shard's last row),
// whose data flow seg_scan.cu's header sets out in three steps; reduce
// and carry compute it at the run heads alone:
//   1. reduce runs step 1's doubling on each block exactly (double_block
//      below; a min or max lane of a block without NaN by run_scan, which
//      gives the same bits, those ops being exact), the row ids those of
//      key equality (a masked row its own id, as its own segment id in
//      the plain version), and keeps the value at each head; a head of
//      the block's first run in a block whose first row starts that run
//      (joint) takes step 3's op with the identity (-0.0 + 0.0 is +0.0);
//   2. a head of the first run of a block that is not joint takes
//      op(its value, cv[r - 1]), cv step 2's flagged doubling over the
//      block tails. The blocks from the run's first one (a g block: the
//      run starts in it) to r - 1 (whole-run blocks) are its chain, and
//      the doubling at the chain's last tail depends only on each tail's
//      distance from the chain's first: it is the right-aligned pairwise
//      tree over the chain, node = op(left half, right half), a half past
//      the chain's first tail left out (no op). carry finds the chain's
//      first block among the 32 summary words below, else by a 32-way
//      search of the sorted key, and builds the tree in a warp, 32 tails
//      a lane; a chain over SP_CHAIN tails goes to `chains` in pieces of
//      SP_CHAIN (the tree's nodes at that level), a warp a piece, and the
//      piece that finishes last builds the tree over the pieces.
//
// Bound: memory. keys reads the codes and writes the words once; counts
// and spans read the sorted key once each; reduce reads the sorted key
// and the permutation once, each row's scanned lanes at random, and
// writes a value a head and lane, and a tail a block and lane. A random
// 8-byte read costs a whole 32-byte sector, so with two to four scanned
// lanes keys lays them side by side first (a coalesced pass, 16 or 32
// bytes a row), and reduce copies a row's lanes from one sector into
// shared memory (cp.async, a thread's 32 rows in flight at once), where
// each head's totals then gather into one row write (on an H100, q5's
// three lanes at 2.5e8 rows took 34.8 ms gathered one by one, where one
// lane took 9.1 ms). f64 min and max over a block without NaN go by the
// integers that order the doubles as fmin and fmax do (run_scan: exact,
// so any order gives the doubling's bits), since the FP64 pipe's compares
// made the doubling of q6's two lanes cost ~27 ms. carry, offsets and
// place touch the block tails, per-chunk counts and the n_dev * D slots,
// not the n rows. In counts and spans a warp takes a chunk, SP_UNROLL
// steps of 32 rows loaded together so that each lane has SP_UNROLL loads
// in flight; the ranks of a step's runs within their buckets come from
// warp ballots, one round a bucket present in the step, and the warp's
// running count of each bucket sits in shared memory.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define SP_THREADS 256
#define SP_WARPS (SP_THREADS / 32)
#define SP_ROWS 4
#define SP_UNROLL 4
#define SP_CHUNK 4096
#define SP_SCAN_THREADS 1024
#define SP_MAX_DEV 1024
#define SP_MAX_LANES 32
#define SP_ROW_LANES 4          // the most lanes laid side by side
#define SP_BLOCK 1024           // rows of a scan block: the plain _SEG_B
#define SP_ITEMS 32             // rows a lane holds: SP_BLOCK / 32
#define SP_RED_WARPS 2          // warps (blocks) of a reduce CTA
#define SP_CARRY_WARPS 4        // warps (blocks) of a carry or chains CTA
#define SP_CHAIN 1024           // the most tails a warp's tree takes

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

// -- reduce and carry -------------------------------------------------------

enum { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2 };

// a block's summary word: bits 0-10 the length of its first run in the
// block (1 .. SP_BLOCK); g (the first row's id differs from the last's,
// or joint); joint (the first row's id differs from the row before the
// block's, or the block is the first); carry (not joint, and the first
// run's head, a valid row, lies in the block)
#define SW_LEAD 0x7FFu
#define SW_G (1u << 11)
#define SW_JOINT (1u << 12)
#define SW_CARRY (1u << 13)

// ident, apply and double_block are seg_scan.cu's, copied here unchanged
// but for the names of the constants (SS_ITEMS there is SP_ITEMS), so
// that step 1 adds the same numbers in the same order as the scan.

// the op's identity: the value the plain version's `_IDENT` gives pads
template <int OP, typename T>
__device__ __forceinline__ T ident() {
  if constexpr (OP == OP_SUM) {
    return (T)0;
  } else if constexpr (std::is_same<T, double>::value) {
    return OP == OP_MIN ? __longlong_as_double(0x7FF0000000000000LL)
                        : __longlong_as_double(
                              (long long)0xFFF0000000000000ULL);
  } else if constexpr (std::is_same<T, int32_t>::value) {
    return OP == OP_MIN ? INT32_MAX : INT32_MIN;
  } else {
    return OP == OP_MIN ? INT64_MAX : INT64_MIN;
  }
}

// op(a, b) as the plain version's torch op computes it on the card. Its
// `a + b` is torch.add, whose CUDA functor computes a + alpha * b with a
// runtime alpha of 1: one fma(alpha, b, a). The value is a + b's, but
// which NaN comes out of two NaN operands is the fma's rule, so the f64
// sum is that fma, with `one` a kernel argument (1.0) that the compiler
// cannot fold.
template <int OP, typename T>
__device__ __forceinline__ T apply(T a, T b, double one) {
  if constexpr (OP == OP_SUM) {
    if constexpr (std::is_same<T, double>::value) {
      return __fma_rn(one, b, a);
    } else {
      typedef typename std::make_unsigned<T>::type U;
      return (T)((U)a + (U)b);
    }
  } else if constexpr (std::is_same<T, double>::value) {
    if (a != a) return a;
    if (b != b) return b;
    return OP == OP_MIN ? fmin(a, b) : fmax(a, b);
  } else {
    return OP == OP_MIN ? (a < b ? a : b) : (a > b ? a : b);
  }
}

// Step 1 on the rows 32 k + l (k < 32) that lane l of a warp holds: the
// plain version's doubling, operand for operand, at d = 2^s:
// m[j] = op(m[j], ids[j] == ids[j-d] ? m[j-d] : ident) for j >= d.
template <typename I, typename T, int OP>
__device__ __forceinline__ void double_block(T (&m)[SP_ITEMS],
                                             const I (&id)[SP_ITEMS], int l,
                                             double one) {
  // d = 1 .. 16: row j - d is in lane (l - d) & 31, its item k if l >= d,
  // else its item k - 1; each lane sends the item its partner asks for.
  // Items from the top, so that every operand is the step's old value.
#pragma unroll
  for (int s = 0; s < 5; s++) {
    const int d = 1 << s;
    const int src = (l - d) & 31;
    const bool wrap = l + d >= 32;
#pragma unroll
    for (int k = SP_ITEMS - 1; k >= 0; k--) {
      const T sv = wrap && k > 0 ? m[k > 0 ? k - 1 : 0] : m[k];
      const I si = wrap && k > 0 ? id[k > 0 ? k - 1 : 0] : id[k];
      const T pv = __shfl_sync(FULL, sv, src);
      const I pi = __shfl_sync(FULL, si, src);
      if (k > 0 || l >= d)
        m[k] = apply<OP>(m[k], pi == id[k] ? pv : ident<OP, T>(), one);
    }
  }
  // d = 32 .. 512: item k takes item k - d / 32 of the same lane (the
  // loops' counts are constants, so every index is one and m stays in
  // registers)
#pragma unroll
  for (int s = 0; s < 5; s++) {
    const int e = 1 << s;
#pragma unroll
    for (int k = SP_ITEMS - 1; k >= 0; k--)
      if (k >= e)
        m[k] = apply<OP>(m[k], id[k >= e ? k - e : 0] == id[k]
                                   ? m[k >= e ? k - e : 0]
                                   : ident<OP, T>(),
                         one);
  }
}

// pad and run_scan are seg_scan.cu's too (its look-back route's step 1
// for integer values), copied unchanged but for SS_ITEMS.

// shared-memory index of row i of a block: a pad word every 32 rows, so
// that a lane's 32 rows (blocked: lane l holds rows 32 l + k) and the
// warp's 32 rows of one item (striped: lane l holds rows 32 k + l) both
// fall in 32 banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

// Step 1 for integer values in a block whose ids never turn back (all
// non-decreasing or all non-increasing below row n). There every id's
// rows are one contiguous run, so a row joins the doubling of exactly the
// rows of its run before it, and the doubling is the run's inclusive
// scan; min, max and the wrapping sum are exact, so any association gives
// its bits. The striped rows m go through the warp's shared buffer `sv`
// to blocked layout (`heads` bit k: row 32 l + k starts a run): a
// sequential scan in each lane, a segmented scan of the lanes' trailing
// runs across the warp, the carry into each lane's leading run; and back.
template <typename T, int OP>
__device__ __forceinline__ void run_scan(T (&m)[SP_ITEMS], T* sv,
                                         unsigned heads, int l) {
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) sv[pad(32 * k + l)] = m[k];
  __syncwarp();
  T v[SP_ITEMS];
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) v[k] = sv[pad(32 * l + k)];
#pragma unroll
  for (int k = 1; k < SP_ITEMS; k++)
    if (!((heads >> k) & 1)) v[k] = apply<OP>(v[k - 1], v[k], 1.0);
  int f = heads != 0;
  T x = v[SP_ITEMS - 1];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T px = __shfl_up_sync(FULL, x, o);
    const int pf = __shfl_up_sync(FULL, f, o);
    if (l >= o) {
      if (!f) x = apply<OP>(px, x, 1.0);
      f |= pf;
    }
  }
  const T carry = __shfl_up_sync(FULL, x, 1);
  const int lead = heads ? __ffs(heads) - 1 : SP_ITEMS;
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) {
    if (l > 0 && k < lead) v[k] = apply<OP>(carry, v[k], 1.0);
    sv[pad(32 * l + k)] = v[k];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) m[k] = sv[pad(32 * k + l)];
  __syncwarp();
}

// fn(std::integral_constant<int, OP>) for the runtime op
template <typename F>
__device__ __forceinline__ void by_op(int op, F&& fn) {
  switch (op) {
    case OP_MIN: fn(std::integral_constant<int, OP_MIN>()); break;
    case OP_MAX: fn(std::integral_constant<int, OP_MAX>()); break;
    default: fn(std::integral_constant<int, OP_SUM>()); break;
  }
}

struct ReduceParams {
  int64_t n, R;
  const int32_t* hi;       // the sorted key's (first) word
  const int32_t* lo;       // its low word; null: the key is one word
  int32_t sentinel;        // one word: the masked rows' key
  int n_lanes;
  int width;               // > 0: src[0] is keys' side-by-side rows
  double one;              // 1.0, the f64 sum's alpha (see apply)
  const int32_t* perm;
  const u64* src[SP_MAX_LANES];
  int64_t src_stride[SP_MAX_LANES];
  int ops[SP_MAX_LANES];
  double* heads;           // lane l of sorted row i at i * head_stride + l
  int64_t head_stride;
  uint32_t* words;         // the R summary words
  double* tails;           // R x n_lanes block tails
  int32_t* ctl;            // carry's chain and piece counters, zeroed here
};

struct CarryParams {
  int64_t n, R;
  const int32_t* hi;
  const int32_t* lo;
  int n_lanes;
  double one;
  int ops[SP_MAX_LANES];
  double* heads;
  int64_t head_stride;
  const uint32_t* words;
  const double* tails;
  int32_t* ctl;            // [0] long chains, [1] their pieces
  int32_t* chain;          // a long chain: rb, ra, first piece, pieces, done
  int32_t* piece;          // a piece's chain
  double* pval;            // a piece's tree, by lane
};

// Sorted row i's id: its key where valid (the top bit clear), else a
// value with the top bit set and the row in the others, so that masked
// rows, each its own segment in the plain version, differ from every
// row; rows past n take pad_id, which no row takes.
template <typename I>
__device__ __forceinline__ I row_id(const int32_t* hi, const int32_t* lo,
                                    int32_t sentinel, int64_t i) {
  if constexpr (sizeof(I) == 4) {
    const uint32_t k = (uint32_t)__ldg(hi + i);
    return k == (uint32_t)sentinel ? 0x80000000u | (uint32_t)i : k;
  } else {
    const u64 k = ((u64)(uint32_t)__ldg(hi + i) << 32) |
                  (uint32_t)__ldg(lo + i);
    return k == KEY_MAX_WORDS ? (1ull << 63) | (u64)i : k;
  }
}

template <typename I>
__device__ __forceinline__ I pad_id() { return ~(I)0; }

template <typename I>
__device__ __forceinline__ bool valid_id(I v) {
  return !(v >> (8 * sizeof(I) - 1));
}

// A non-NaN double's bits as an integer that orders as the double does,
// -0.0 below +0.0; its own inverse.
__device__ __forceinline__ long long fkey(long long s) {
  return s ^ ((s >> 63) & 0x7FFFFFFFFFFFFFFFLL);
}

// A stage: block r's rows' n_lanes (2 to 4) side-by-side values in
// shared memory, lanes 0 and 1 (and 2 and 3 of four) as 16-byte pairs, the
// third of three alone; the index of row j's lane lv.
__device__ __forceinline__ int slot(int j, int lv, int n_lanes) {
  return lv < 2 ? 2 * j + lv
                : n_lanes == 4 ? 2 * SP_BLOCK + 2 * j + lv - 2
                               : 2 * SP_BLOCK + j;
}

// Lane lv of a block after its gather (m: the rows' values, pads
// anything): step 1, the block's tail and each head's value, into the
// stage where the lanes came side by side, else straight into heads.
// starts: the blocked rows that start a run (bit k: row 32 l + k); sv:
// the warp's run_scan buffer.
template <typename I, int OP>
__device__ __forceinline__ void reduce_lane(
    const ReduceParams& p, int lv, double (&m)[SP_ITEMS],
    const I (&id)[SP_ITEMS], int64_t rem, int64_t r, int64_t p0,
    unsigned heads, unsigned firsts, unsigned starts, bool joint,
    double* stage, long long* sv, int l) {
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++)
    if (32 * k + l >= rem) m[k] = ident<OP, double>();
  bool nan = false;
  if (OP != OP_SUM) {
#pragma unroll
    for (int k = 0; k < SP_ITEMS; k++) nan |= m[k] != m[k];
  }
  if (OP != OP_SUM && !__any_sync(FULL, nan)) {
    // over no NaN, f64 min and max are the integer min and max of fkey,
    // which gives -0.0 and +0.0 the order fmin and fmax give them: exact,
    // so the doubling equals each run's own scan (run_scan), and the f64
    // compares, which the FP64 pipe runs at a fraction of its rate, go
    long long q[SP_ITEMS];
#pragma unroll
    for (int k = 0; k < SP_ITEMS; k++) q[k] = fkey(__double_as_longlong(m[k]));
    run_scan<long long, OP>(q, sv, starts, l);
#pragma unroll
    for (int k = 0; k < SP_ITEMS; k++) m[k] = __longlong_as_double(fkey(q[k]));
  } else {
    double_block<I, double, OP>(m, id, l, p.one);
  }
  if (l == 31) p.tails[r * p.n_lanes + lv] = m[SP_ITEMS - 1];
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) {
    if (!((heads >> k) & 1)) continue;
    double v = m[k];
    // step 3 at the first run's head of a joint block: op(m, ident),
    // which only the f64 sum can change (-0.0 + 0.0)
    if (OP == OP_SUM && joint && ((firsts >> k) & 1))
      v = apply<OP>(v, ident<OP, double>(), p.one);
    if (stage)
      stage[slot(32 * k + l, lv, p.n_lanes)] = v;
    else
      p.heads[(p0 - 32 * k) * p.head_stride + lv] = v;
  }
}

template <typename I, bool MINMAX>
__device__ __forceinline__ void reduce_op(
    const ReduceParams& p, int lv, double (&m)[SP_ITEMS],
    const I (&id)[SP_ITEMS], int64_t rem, int64_t r, int64_t p0,
    unsigned heads, unsigned firsts, unsigned starts, bool joint,
    double* stage, long long* sv, int l) {
  switch (MINMAX ? p.ops[lv] : OP_SUM) {
    case OP_MIN:
      reduce_lane<I, OP_MIN>(p, lv, m, id, rem, r, p0, heads, firsts, starts,
                             joint, stage, sv, l);
      break;
    case OP_MAX:
      reduce_lane<I, OP_MAX>(p, lv, m, id, rem, r, p0, heads, firsts, starts,
                             joint, stage, sv, l);
      break;
    default:
      reduce_lane<I, OP_SUM>(p, lv, m, id, rem, r, p0, heads, firsts, starts,
                             joint, stage, sv, l);
  }
}

// Block r's ids (item k: sorted row p0 - 32 k), its heads (valid rows
// whose next row has another id), the rows of its first run, the blocked
// rows that start a run (bit k: row 32 l + k), and whether it is joint;
// writes its summary word. Its ctl counters are zeroed by block 0.
template <typename I>
__device__ __forceinline__ void block_ids(const ReduceParams& p, int64_t r,
                                          int l, I (&id)[SP_ITEMS],
                                          unsigned& heads, unsigned& firsts,
                                          unsigned& starts, bool& joint) {
  const int64_t base = r * SP_BLOCK;
  const int64_t rem = p.n - base;
  const int64_t p0 = p.n - 1 - base - l;
  if (r == 0 && l == 0) {
    p.ctl[0] = 0;
    p.ctl[1] = 0;
  }
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++)
    id[k] = 32 * k + l < rem ? row_id<I>(p.hi, p.lo, p.sentinel, p0 - 32 * k)
                             : pad_id<I>();
  const I first = __shfl_sync(FULL, id[0], 0);
  const I last = __shfl_sync(FULL, id[SP_ITEMS - 1], 31);
  joint = r == 0 || first != row_id<I>(p.hi, p.lo, p.sentinel, p.n - base);
  // the id of the row after the block's last
  const I after = rem > SP_BLOCK
                      ? row_id<I>(p.hi, p.lo, p.sentinel, p0 + l - SP_BLOCK)
                      : pad_id<I>();
  heads = firsts = starts = 0;
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) {
    const I below = __shfl_down_sync(FULL, id[k], 1);
    const I wrap = __shfl_sync(FULL, id[k + 1 < SP_ITEMS ? k + 1 : k], 0);
    const I nx = l < 31 ? below : k + 1 < SP_ITEMS ? wrap : after;
    if (valid_id(id[k]) && nx != id[k]) heads |= 1u << k;
    if (id[k] == first) firsts |= 1u << k;
    const I si = l == 31 && k > 0 ? id[k > 0 ? k - 1 : 0] : id[k];
    const I up = __shfl_sync(FULL, si, (l - 1) & 31);
    const unsigned b = __ballot_sync(FULL, (32 * k + l == 0) || up != id[k]);
    if (l == k) starts = b;
  }
  unsigned lead = SP_BLOCK;
#pragma unroll
  for (int k = SP_ITEMS - 1; k >= 0; k--)
    if (!((firsts >> k) & 1)) lead = 32 * k + l;
  lead = __reduce_min_sync(FULL, lead);
  const bool head_here =
      valid_id(first) && (lead < SP_BLOCK || after != first);
  if (l == 0)
    p.words[r] = lead | (joint || first != last ? SW_G : 0u) |
                 (joint ? SW_JOINT : 0u) |
                 (!joint && head_here ? SW_CARRY : 0u);
}

// copies from global to shared memory that no register holds: 16 bytes
// (global only through L2) and 8
__device__ __forceinline__ void copy16(double* smem, const double* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(g));
}
__device__ __forceinline__ void copy8(double* smem, const double* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(g));
}

// Block r's side-by-side rows into a stage, a copy group of the thread's
// own 32 rows (all in flight at once).
__device__ __forceinline__ void fetch(const ReduceParams& p, int64_t r,
                                      double* stage, int l) {
  const int64_t rem = p.n - r * SP_BLOCK;
  const int64_t p0 = p.n - 1 - r * SP_BLOCK - l;
  int32_t at[SP_ITEMS];
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++)
    at[k] = 32 * k + l < rem ? __ldg(p.perm + p0 - 32 * k) : 0;
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) {
    if (32 * k + l >= rem) continue;
    const double* g = (const double*)p.src[0] + (int64_t)at[k] * p.width;
    const int j = 32 * k + l;
    copy16(stage + 2 * j, g);
    if (p.n_lanes == 4)
      copy16(stage + 2 * SP_BLOCK + 2 * j, g + 2);
    else if (p.n_lanes == 3)
      copy8(stage + 2 * SP_BLOCK + j, g + 2);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One warp a block of the reversed layout, lanes read one at a time
// through the permutation into registers: block r holds the logical rows
// r * SP_BLOCK + 32 k + l, the sorted rows n - 1 - that (the plain
// version's flip). MINMAX: some lane's op is min or max (a build without
// their paths keeps the sums' registers).
template <typename I, bool MINMAX>
__global__ void __launch_bounds__(32 * SP_RED_WARPS, 8 / SP_RED_WARPS)
reduce(const __grid_constant__ ReduceParams p) {
  extern __shared__ __align__(16) double s_sv[];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * SP_RED_WARPS + w;
  if (r >= p.R) return;
  const int64_t rem = p.n - r * SP_BLOCK;
  const int64_t p0 = p.n - 1 - r * SP_BLOCK - l;
  I id[SP_ITEMS];
  unsigned heads, firsts, starts;
  bool joint;
  block_ids<I>(p, r, l, id, heads, firsts, starts, joint);
  int32_t at[SP_ITEMS];
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++)
    at[k] = 32 * k + l < rem ? __ldg(p.perm + p0 - 32 * k) : 0;
  for (int lv = 0; lv < p.n_lanes; lv++) {
    const long long* src = (const long long*)p.src[lv];
    const int64_t st = p.src_stride[lv];
    double m[SP_ITEMS];
#pragma unroll
    for (int k = 0; k < SP_ITEMS; k++)
      m[k] = 32 * k + l < rem
                 ? __longlong_as_double(__ldg(src + (int64_t)at[k] * st))
                 : 0.0;
    reduce_op<I, MINMAX>(p, lv, m, id, rem, r, p0, heads, firsts, starts,
                         joint, nullptr,
                         (long long*)s_sv + w * (SP_BLOCK + 32), l);
  }
}

// The same for 2 to 4 lanes side by side: block r's rows come whole into
// the warp's stage by asynchronous copies (all 32 of a thread's in flight
// at once) while it finds the block's runs, and a head's n_lanes totals
// leave the stage together.
template <typename I, bool MINMAX>
__global__ void __launch_bounds__(32 * SP_RED_WARPS, 8 / SP_RED_WARPS)
reduce_rows(const __grid_constant__ ReduceParams p) {
  extern __shared__ __align__(16) double s_stage[];
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * SP_RED_WARPS + w;
  if (r >= p.R) return;
  // the warp's stage and run_scan buffer
  double* stage =
      s_stage + w * (p.n_lanes * SP_BLOCK + (MINMAX ? SP_BLOCK + 32 : 0));
  const int64_t rem = p.n - r * SP_BLOCK;
  const int64_t p0 = p.n - 1 - r * SP_BLOCK - l;
  long long* sv = (long long*)(stage + p.n_lanes * SP_BLOCK);
  fetch(p, r, stage, l);
  I id[SP_ITEMS];
  unsigned heads, firsts, starts;
  bool joint;
  block_ids<I>(p, r, l, id, heads, firsts, starts, joint);
  // a thread reads back only the rows it copied
  asm volatile("cp.async.wait_all;" ::: "memory");
  for (int lv = 0; lv < p.n_lanes; lv++) {
    double m[SP_ITEMS];
#pragma unroll
    for (int k = 0; k < SP_ITEMS; k++)
      m[k] = stage[slot(32 * k + l, lv, p.n_lanes)];
    reduce_op<I, MINMAX>(p, lv, m, id, rem, r, p0, heads, firsts, starts,
                         joint, stage, sv, l);
  }
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++) {
    if (!((heads >> k) & 1)) continue;
    const int j = 32 * k + l;
    const int64_t h = p0 - 32 * k;
    double* o = p.heads + h * p.n_lanes;
    const double2 a = ((const double2*)stage)[j];
    if (p.n_lanes == 2) {
      *(double2*)o = a;
    } else if (p.n_lanes == 4) {
      *(double2*)o = a;
      *(double2*)(o + 2) = ((const double2*)(stage + 2 * SP_BLOCK))[j];
    } else if (h & 1) {
      // a row of three at an odd row starts 8 bytes past 16-byte alignment
      o[0] = a.x;
      *(double2*)(o + 1) = make_double2(a.y, stage[2 * SP_BLOCK + j]);
    } else {
      *(double2*)o = a;
      o[2] = stage[2 * SP_BLOCK + j];
    }
  }
}

// Step 2's value at a chain's last tail: over `count` tails (1 .. SP_CHAIN),
// tail j = at(j) counted from the chain's end (j = 0 the last), the
// right-aligned tree whose node is op(left half, right half), a half that
// lies wholly past the chain's first tail left out. Lane l holds tails
// 32 l .. 32 l + 31 (an aligned subtree); the lanes' subtrees meet by
// shuffles. Every lane returns the total.
template <int OP, typename F>
__device__ __forceinline__ double chain_tree(int count, int l, double one,
                                             F&& at) {
  double v[SP_ITEMS];
#pragma unroll
  for (int k = 0; k < SP_ITEMS; k++)
    v[k] = 32 * l + k < count ? at(32 * l + k) : 0.0;
#pragma unroll
  for (int h = 1; h < SP_ITEMS; h <<= 1)
#pragma unroll
    for (int k = 0; k + h < SP_ITEMS; k += 2 * h)
      if (32 * l + k + h < count) v[k] = apply<OP>(v[k + h], v[k], one);
  double x = v[0];
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double y = __shfl_down_sync(FULL, x, o);
    if ((l & (2 * o - 1)) == 0 && 32 * (l + o) < count)
      x = apply<OP>(y, x, one);
  }
  return __shfl_sync(FULL, x, 0);
}

// step 3 at head row h for lane lv: op(its value, pfx)
template <int OP>
__device__ __forceinline__ void finish(const CarryParams& p, int64_t h,
                                       int lv, double pfx, int l) {
  if (l == 0) {
    double* o = p.heads + h * p.head_stride + lv;
    *o = apply<OP>(*o, pfx, p.one);
  }
}

// The first block of the chain that ends at block rb - 1 (rb's first run
// came in from it): the nearest g block below rb among the 32 summary
// words there, else the lowest block r whose last row holds the head's
// key (true from there up to rb - 1), by a 32-way gallop and search.
__device__ int64_t chain_start(const CarryParams& p, int64_t rb, int64_t h,
                               int l) {
  const int64_t r0 = rb - 1 - l;
  const unsigned gb =
      __ballot_sync(FULL, r0 >= 0 && (__ldg(p.words + r0) & SW_G));
  if (gb) return rb - 1 - (__ffs(gb) - 1);
  const int32_t khi = __ldg(p.hi + h);
  const int32_t klo = p.lo ? __ldg(p.lo + h) : 0;
  auto same = [&](int64_t r) {
    const int64_t i = p.n - SP_BLOCK * (r + 1);
    return __ldg(p.hi + i) == khi && (!p.lo || __ldg(p.lo + i) == klo);
  };
  // the 32 blocks below rb are whole-run blocks: t(rb - 32) holds
  int64_t hi = rb - 32, lo = -1, step = 32;
  for (;;) {
    const int64_t q = hi - step * (l + 1);
    const unsigned fb = __ballot_sync(FULL, !(q >= 0 && same(q)));
    if (fb) {
      const int f = __ffs(fb) - 1;
      lo = hi - step * (f + 1);
      hi -= step * f;
      break;
    }
    hi -= step * 32;
    step *= 32;
  }
  if (lo < -1) lo = -1;
  // t(lo) false (or lo = -1), t(hi) true
  while (hi - lo > 1) {
    const int64_t st = (hi - lo + 31) / 32;
    const int64_t q = lo + st * (l + 1);
    const unsigned tb = __ballot_sync(FULL, q >= hi || same(q));
    const int f = __ffs(tb) - 1;
    const int64_t nh = lo + st * (f + 1);
    lo += st * f;
    if (nh < hi) hi = nh;
  }
  return hi;
}

// One warp a block: a block whose summary word says carry gets its first
// run's head total, from its chain's tree where the chain has at most
// SP_CHAIN tails, else the chain is listed for `chains`.
__global__ void __launch_bounds__(32 * SP_CARRY_WARPS)
carry(const __grid_constant__ CarryParams p) {
  const int l = threadIdx.x & 31;
  const int64_t rb =
      (int64_t)blockIdx.x * SP_CARRY_WARPS + (threadIdx.x >> 5);
  if (rb >= p.R) return;
  const uint32_t w = __ldg(p.words + rb);
  if (!(w & SW_CARRY)) return;
  const int64_t h = p.n - rb * SP_BLOCK - (int64_t)(w & SW_LEAD);
  const int64_t ra = chain_start(p, rb, h, l);
  const int64_t K = rb - ra;
  if (K <= SP_CHAIN) {
    for (int lv = 0; lv < p.n_lanes; lv++)
      by_op(p.ops[lv], [&](auto op) {
        constexpr int OP = decltype(op)::value;
        const double pfx = chain_tree<OP>((int)K, l, p.one, [&](int j) {
          return __ldg(p.tails + (rb - 1 - j) * p.n_lanes + lv);
        });
        finish<OP>(p, h, lv, pfx, l);
      });
    return;
  }
  const int32_t pc = (int32_t)((K + SP_CHAIN - 1) / SP_CHAIN);
  int32_t c = 0, pb = 0;
  if (l == 0) {
    c = atomicAdd(p.ctl, 1);
    pb = atomicAdd(p.ctl + 1, pc);
    int32_t* d = p.chain + 5 * (int64_t)c;
    d[0] = (int32_t)rb;
    d[1] = (int32_t)ra;
    d[2] = pb;
    d[3] = pc;
    d[4] = 0;
  }
  c = __shfl_sync(FULL, c, 0);
  pb = __shfl_sync(FULL, pb, 0);
  for (int32_t i = l; i < pc; i += 32) p.piece[pb + i] = c;
}

// One warp a listed piece: piece i of a chain ending at block e = rb - 1
// holds the tails e - i SP_CHAIN - j, j < SP_CHAIN (down to the chain's
// first), the tree's node at that level. The piece that completes its
// chain last builds the tree over the chain's pieces (piece 0 the last;
// at most 2 SP_CHAIN pieces, since n < 2^31) and finishes the head.
__global__ void __launch_bounds__(32 * SP_CARRY_WARPS)
chains(const __grid_constant__ CarryParams p) {
  const int l = threadIdx.x & 31;
  const int64_t pid =
      (int64_t)blockIdx.x * SP_CARRY_WARPS + (threadIdx.x >> 5);
  if (pid >= p.ctl[1]) return;
  const int32_t c = p.piece[pid];
  int32_t* d = p.chain + 5 * (int64_t)c;
  const int64_t rb = d[0], ra = d[1];
  const int32_t pb = d[2], pc = d[3];
  const int64_t e = rb - 1 - (pid - pb) * SP_CHAIN;
  const int cnt = (int)(e - ra + 1 < SP_CHAIN ? e - ra + 1 : SP_CHAIN);
  const int L = p.n_lanes;
  for (int lv = 0; lv < L; lv++)
    by_op(p.ops[lv], [&](auto op) {
      constexpr int OP = decltype(op)::value;
      const double v = chain_tree<OP>(cnt, l, p.one, [&](int j) {
        return __ldg(p.tails + (e - j) * L + lv);
      });
      if (l == 0) p.pval[pid * L + lv] = v;
    });
  __threadfence();
  int32_t t = 0;
  if (l == 0) t = atomicAdd(d + 4, 1);
  t = __shfl_sync(FULL, t, 0);
  if (t != pc - 1) return;
  __threadfence();
  const int64_t h =
      p.n - rb * SP_BLOCK - (int64_t)(__ldg(p.words + rb) & SW_LEAD);
  for (int lv = 0; lv < L; lv++)
    by_op(p.ops[lv], [&](auto op) {
      constexpr int OP = decltype(op)::value;
      auto piece = [&](int j) { return __ldcg(p.pval + (pb + j) * L + lv); };
      double pfx = chain_tree<OP>(pc < SP_CHAIN ? pc : SP_CHAIN, l, p.one,
                                  piece);
      if (pc > SP_CHAIN)
        pfx = apply<OP>(chain_tree<OP>(pc - SP_CHAIN, l, p.one,
                                       [&](int j) {
                                         return piece(SP_CHAIN + j);
                                       }),
                        pfx, p.one);
      finish<OP>(p, h, lv, pfx, l);
    });
}

// The scratch of reduce and carry for n rows and L lanes (R blocks), each
// region 256-byte aligned: R summary words, R x L tails, the two counters,
// and for the long chains (over SP_CHAIN tails, so fewer than
// R / SP_CHAIN + 1) their records, their pieces' chains and the pieces'
// trees (fewer than 2 R / SP_CHAIN + 2 pieces).
struct Scratch {
  int64_t words, tails, ctl, chain, piece, pval, total, max_pieces;
};

static int64_t a256(int64_t x) { return (x + 255) & ~(int64_t)255; }

static Scratch scratch_of(int64_t n, int lanes) {
  const int64_t R = (n + SP_BLOCK - 1) / SP_BLOCK;
  const int64_t n_chains = R / SP_CHAIN + 1;
  Scratch s;
  s.max_pieces = 2 * (R / SP_CHAIN) + 2;
  s.words = 0;
  s.tails = a256(4 * R);
  s.ctl = s.tails + a256(8 * R * lanes);
  s.chain = s.ctl + 256;
  s.piece = s.chain + a256(20 * n_chains);
  s.pval = s.piece + a256(4 * s.max_pieces);
  s.total = s.pval + a256(8 * s.max_pieces * lanes);
  return s;
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

// Bytes of the scratch that rf_shard_partials_reduce and
// rf_shard_partials_carry share for n rows of n_lanes lanes; -1 for
// arguments they do not take.
extern "C" int64_t rf_shard_partials_scratch_bytes(int64_t n, int n_lanes) {
  if (n < 0 || n_lanes < 1 || n_lanes > SP_MAX_LANES) return -1;
  return scratch_of(n, n_lanes).total;
}

// Step 1 of each run's total over n sorted rows (hi, and lo for a
// two-word key; one word: masked rows at `sentinel`) and the sort's
// permutation perm: lane l (op ops[l]: 0 min, 1 max, 2 sum) of sorted row
// i is src[l][perm[i] * src_stride[l]], or with width > 0 (2 or 4, at
// least n_lanes >= 2) src[0][perm[i] * width + l], keys' side-by-side rows
// (16-byte aligned), each as an f64. Writes heads[i * head_stride + l]
// at each run's first sorted row i alone (every other row of heads is
// left as it was; with width > 0, head_stride is n_lanes and heads
// 16-byte aligned), and the block tails and summary words into scratch
// (rf_shard_partials_scratch_bytes), which rf_shard_partials_carry then
// reads. One launch; returns 0 or its cudaError; cudaErrorInvalidValue
// for arguments it does not take.
extern "C" int rf_shard_partials_reduce(
    int64_t n, const void* hi, const void* lo, int sentinel,
    const void* perm, int n_lanes, const int* ops, const void* const* src,
    const int64_t* src_stride, int width, void* heads, int64_t head_stride,
    void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 31) - 1 || n_lanes < 1 ||
      n_lanes > SP_MAX_LANES || head_stride < n_lanes ||
      (width && (n_lanes < 2 || n_lanes > width ||
                 (width != 2 && width != 4) || head_stride != n_lanes ||
                 ((uintptr_t)src[0] & 15) || ((uintptr_t)heads & 15))))
    return (int)cudaErrorInvalidValue;
  ReduceParams p = {};
  p.n = n;
  p.R = (n + SP_BLOCK - 1) / SP_BLOCK;
  p.hi = (const int32_t*)hi;
  p.lo = (const int32_t*)lo;
  p.sentinel = sentinel;
  p.n_lanes = n_lanes;
  p.width = width;
  p.one = 1.0;
  p.perm = (const int32_t*)perm;
  for (int l = 0; l < n_lanes; ++l) {
    if (ops[l] < OP_MIN || ops[l] > OP_SUM) return (int)cudaErrorInvalidValue;
    p.ops[l] = ops[l];
    p.src[l] = (const u64*)src[width ? 0 : l];
    p.src_stride[l] = width ? 0 : src_stride[l];
  }
  p.heads = (double*)heads;
  p.head_stride = head_stride;
  const Scratch s = scratch_of(n, n_lanes);
  char* base = (char*)scratch;
  p.words = (uint32_t*)(base + s.words);
  p.tails = (double*)(base + s.tails);
  p.ctl = (int32_t*)(base + s.ctl);
  if (n == 0) return 0;
  bool minmax = false;
  for (int l = 0; l < n_lanes; ++l) minmax |= ops[l] != OP_SUM;
  // a CTA's shared memory: each warp's stage, and min and max's
  // run_scan buffer
  const int smem = SP_RED_WARPS *
                   (SP_BLOCK * (width ? n_lanes : 0) +
                    (minmax ? SP_BLOCK + 32 : 0)) * (int)sizeof(double);
  cudaStream_t st = (cudaStream_t)stream;
  auto launch = [&](auto kernel) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)((p.R + SP_RED_WARPS - 1) / SP_RED_WARPS),
             32 * SP_RED_WARPS, smem, st>>>(p);
    return (int)cudaGetLastError();
  };
  if (lo != nullptr) {
    if (width)
      return minmax ? launch(reduce_rows<u64, true>)
                    : launch(reduce_rows<u64, false>);
    return minmax ? launch(reduce<u64, true>) : launch(reduce<u64, false>);
  }
  if (width)
    return minmax ? launch(reduce_rows<uint32_t, true>)
                  : launch(reduce_rows<uint32_t, false>);
  return minmax ? launch(reduce<uint32_t, true>)
                : launch(reduce<uint32_t, false>);
}

// Steps 2 and 3 after rf_shard_partials_reduce of the same n rows, key,
// lanes, ops, heads and scratch: each run head whose run reaches into
// earlier blocks of the reversed layout gets op(its value, its chain's
// tree). Two launches (none below two blocks, one below SP_CHAIN + 2);
// returns 0 or the first cudaError; cudaErrorInvalidValue for arguments
// it does not take.
extern "C" int rf_shard_partials_carry(int64_t n, const void* hi,
                                       const void* lo, int n_lanes,
                                       const int* ops, void* heads,
                                       int64_t head_stride, void* scratch,
                                       void* stream) {
  if (n < 0 || n >= (1LL << 31) - 1 || n_lanes < 1 ||
      n_lanes > SP_MAX_LANES || head_stride < n_lanes)
    return (int)cudaErrorInvalidValue;
  CarryParams p = {};
  p.n = n;
  p.R = (n + SP_BLOCK - 1) / SP_BLOCK;
  p.hi = (const int32_t*)hi;
  p.lo = (const int32_t*)lo;
  p.n_lanes = n_lanes;
  p.one = 1.0;
  for (int l = 0; l < n_lanes; ++l) {
    if (ops[l] < OP_MIN || ops[l] > OP_SUM) return (int)cudaErrorInvalidValue;
    p.ops[l] = ops[l];
  }
  p.heads = (double*)heads;
  p.head_stride = head_stride;
  const Scratch s = scratch_of(n, n_lanes);
  char* base = (char*)scratch;
  p.words = (const uint32_t*)(base + s.words);
  p.tails = (const double*)(base + s.tails);
  p.ctl = (int32_t*)(base + s.ctl);
  p.chain = (int32_t*)(base + s.chain);
  p.piece = (int32_t*)(base + s.piece);
  p.pval = (double*)(base + s.pval);
  if (p.R < 2) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  carry<<<(unsigned)((p.R + SP_CARRY_WARPS - 1) / SP_CARRY_WARPS),
          32 * SP_CARRY_WARPS, 0, st>>>(p);
  int rc = (int)cudaGetLastError();
  if (rc || p.R - 1 <= SP_CHAIN) return rc;
  chains<<<(unsigned)((s.max_pieces + SP_CARRY_WARPS - 1) /
                      SP_CARRY_WARPS),
           32 * SP_CARRY_WARPS, 0, st>>>(p);
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
