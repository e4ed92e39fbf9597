// Stable LSD radix sort of M parallel int32 words by their first n_keys
// words, compared as a signed-i32 lexicographic key, ascending.
//
// Replaces the TPU package's blocked bitonic sort: both of its
// pl.pallas_call sites (rayforce_tpu/engine/psort.py, `_block_kernel`
// launched from `_sort_padded` for phase A, `_window_pass_kernel` for
// phase B). The TPU chose a data-oblivious bitonic network because it has
// no fast scatter; Hopper scatters well, so this is the reference C
// engine's own algorithm instead (an LSD radix sort of row indices,
// rayforce core/sort.c), laid out as a one-sweep sort (Adinets and
// Merrill, "Onesweep", 2022).
//
// Design. Key words are sorted from the last to the first, 8 bits a pass,
// so 4 * n_keys passes; pass p sorts byte p % 4 of key word
// n_keys - 1 - p / 4. Words travel as they are; the digit is taken from
// the word with its sign bit flipped, so unsigned digit order is signed
// order. A large sort (n > 8192) is
//   memset         one per call: the histogram, the tile counters and the
//                  look-back status words;
//   hist_kernel    one read of every key word in its original order
//                  counts all 4 digits of every key word (a digit's
//                  counts do not depend on row order): per-warp shared
//                  counts, merged by integer atomics;
//   plan_kernel    one block: every pass's digit bases; a pass is skipped
//                  when one digit holds all n rows; which buffer each pass
//                  reads and writes and which key word the next pass that
//                  runs sorts. Nothing waits for the host.
//   pass_kernel    one launch per pass, one sweep. A block takes its tile
//                  (4096 rows) from an atomic counter, loads it into
//                  registers (16 rows a thread, every load issued before
//                  any is used), ranks the digits in row order (each warp
//                  owns a run of the tile and finds equal digits with
//                  eight ballots), publishes its digit counts, stages the
//                  tile by digit in shared memory, gets its exclusive
//                  prefix by a decoupled look-back over 64-bit status
//                  words (pass tag, flag and count in one word) and writes
//                  runs of consecutive addresses.
// The passes move the words by one of two routes:
//   carry          every word (and the row ids, when the permutation is
//                  asked for) moves through every pass; no gather. This
//                  includes the key-only sorts, which move the key words
//                  themselves;
//   id             the digit word and the row ids move; the first pass
//                  that runs reads the key in its original order with an
//                  implicit iota; the last pass of a key word writes the
//                  next key word gathered through the ids; gather_kernel
//                  reads the ids once and gathers every other word.
// The host picks the route that its byte estimate says is smaller
// (pick_id_route): carry for few words, id for many words over many passes
// (the wide engine's 4 key words + 1 payload word).
//   small_kernel   n <= 8192: the whole sort in one launch of one block,
//                  in shared memory (the order sorts).
//
// Bound: memory. The yardstick is one read and one write of every word,
// 2 * n * M * 4 B. This design moves, per row: 4 B per key word for the
// histogram; per pass that runs, 8 B per carried word (carry route) or
// 16 B (id route; the first pass reads 4 B less); on the id route a
// random 4-byte read per gathered word, which pulls a 32-byte sector, plus
// 8 B to read the id and write the word. At sort-agg's main shape, 1 key
// word + 1 payload word with 3 of 4 passes running, that is 4 + 3 * 16 =
// 52 B a row against the yardstick's 16: a radix sort pays one pass over
// the data per 8-bit digit that varies.
//
// Scratch comes from the caller in one buffer (rf_radix_sort_scratch_bytes);
// every kernel runs on the caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#define RS_THREADS 256                    // pass, hist, plan block size
#define RS_WARPS (RS_THREADS / 32)
#define RS_ITEMS 16                       // rows per thread in a pass
#define RS_SEG (RS_ITEMS * 32)            // rows per warp in a tile
#define RS_TILE (RS_SEG * RS_WARPS)       // rows per tile
#define RS_BINS 256
#define RS_MAX_KEYS 16
#define RS_MAX_PASSES (4 * RS_MAX_KEYS)
#define RS_MAX_FUSED 16                   // words a launch takes by value
#define RS_MAX_SLOTS (RS_MAX_KEYS + 1)    // carried words, and the row ids
#define RS_EW_BLOCKS 2048                 // grid cap, elementwise kernels
#define RS_HIST_BLOCKS 528                // grid cap per key word
#define RS_GATHER_WINDOW (5 << 20)        // rows a gather reads at random
#define RS_SMALL_MAX 8192                 // rows of the one-block route
#define RS_SMALL_THREADS 1024
#define RS_SMALL_WARPS (RS_SMALL_THREADS / 32)
#define SIGN 0x80000000u

// device state (int32), at the head of the scratch buffer
#define ST_BASE 0                                  // [pass][256] bases
#define ST_SKIP (ST_BASE + RS_MAX_PASSES * RS_BINS)  // [pass] skipped
#define ST_IN (ST_SKIP + RS_MAX_PASSES)    // [pass] buffer read, -1 inputs
#define ST_OUTB (ST_IN + RS_MAX_PASSES)    // [pass] buffer written
#define ST_NEXTW (ST_OUTB + RS_MAX_PASSES) // [pass] next run's word, -1 last
#define ST_FIRST (ST_NEXTW + RS_MAX_PASSES)  // first pass that runs, or -1
#define ST_LASTW (ST_FIRST + 1)            // word the last run sorted
#define ST_INTS (ST_LASTW + 1)

#define SMALL_SMEM \
  (3 * RS_SMALL_MAX * 4 + RS_SMALL_MAX + RS_SMALL_WARPS * RS_BINS * 4)

struct Words {
  const int32_t* in[RS_MAX_FUSED];
  int32_t* out[RS_MAX_FUSED];
};

// the words a pass carries: where the first pass reads each (null: the
// row ids, an implicit iota), where the last pass writes it, and its two
// ping-pong buffers
struct Slots {
  const uint32_t* src[RS_MAX_SLOTS];
  uint32_t* dst[RS_MAX_SLOTS];
  uint32_t* buf[2][RS_MAX_SLOTS];
};

typedef unsigned long long u64;

__device__ __forceinline__ void st_release(u64* p, u64 v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Inclusive scan of one int per thread over a 256-thread block; *total
// receives the block's sum. Every thread of the block must call it.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* total) {
  __shared__ int32_t wsum[RS_WARPS];
  int lane = threadIdx.x & 31;
  int w = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int32_t y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) wsum[w] = v;
  __syncthreads();
  if (w == 0) {
    int32_t s = lane < RS_WARPS ? wsum[lane] : 0;
    for (int o = 1; o < RS_WARPS; o <<= 1) {
      int32_t y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < RS_WARPS) wsum[lane] = s;
  }
  __syncthreads();
  int32_t out = v + (w > 0 ? wsum[w - 1] : 0);
  *total = wsum[RS_WARPS - 1];
  __syncthreads();
  return out;
}

// The lanes whose 8-bit digit equals this lane's, among the lanes with ok
// set: eight ballots, as CUB's onesweep does. (__match_any_sync gives the
// same mask in one instruction, but its time grows with the number of
// distinct digits in the warp.)
__device__ __forceinline__ unsigned match_digit(unsigned d, bool ok) {
  unsigned peers = __ballot_sync(0xffffffffu, ok);
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    unsigned bal = __ballot_sync(0xffffffffu, (d >> b) & 1u);
    peers &= bal ^ (((d >> b) & 1u) - 1u);   // bal where the bit is set
  }
  return peers;
}

// Rank of this lane's digit d among the warp's rows of equal digit so far
// (row order: earlier calls, then lower lanes); cnt[d] is the warp's
// running count. Lanes with ok false pass no digit and get no rank.
__device__ __forceinline__ int warp_rank(int32_t* cnt, unsigned d, bool ok) {
  int lane = threadIdx.x & 31;
  unsigned peers = match_digit(d, ok);
  int before = ok ? cnt[d] : 0;
  int rank = before + __popc(peers & ((1u << lane) - 1u));
  __syncwarp();
  if (ok && lane == 31 - __clz(peers)) cnt[d] = before + __popc(peers);
  __syncwarp();
  return rank;
}

// A warp-striped tile of one word: row wbase + 32 j for j < ITEMS (each
// load of a warp is 128 consecutive bytes), all issued before any is used;
// a null src is the row ids.
template <int ITEMS>
__device__ __forceinline__ void load_tile(uint32_t (&u)[ITEMS],
                                          const uint32_t* src,
                                          int64_t wbase, int64_t n) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    int64_t i = wbase + j * 32;
    u[j] = i < n ? (src ? src[i] : (uint32_t)i) : 0u;
  }
}

// Count one digit into a warp's shared counts: one add when the whole
// warp holds the same digit (a skipped pass's digit would otherwise put
// 32 atomics on one address), one atomic a lane otherwise.
__device__ __forceinline__ void warp_count(int32_t* h, unsigned d, bool ok) {
  unsigned d0 = __shfl_sync(0xffffffffu, d, 0);
  if (__all_sync(0xffffffffu, ok && d == d0)) {
    if ((threadIdx.x & 31) == 0) atomicAdd(&h[d0], 32);
  } else if (ok) {
    atomicAdd(&h[d], 1);
  }
}

__device__ __forceinline__ void count4(int32_t (*h)[RS_BINS], uint32_t v,
                                       bool ok) {
  warp_count(h[0], v & 255u, ok);
  warp_count(h[1], (v >> 8) & 255u, ok);
  warp_count(h[2], (v >> 16) & 255u, ok);
  warp_count(h[3], v >> 24, ok);
}

// grid (blocks, n_keys): every digit of key word blockIdx.y into
// hist[pass][256]. 16-byte loads over the aligned body of the word.
__global__ void __launch_bounds__(RS_THREADS)
    hist_kernel(Words w, int n_keys, int64_t n, int32_t* __restrict__ hist) {
  __shared__ int32_t h[RS_WARPS][4][RS_BINS];
  int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < RS_WARPS * 4 * RS_BINS; i += RS_THREADS)
    (&h[0][0][0])[i] = 0;
  __syncthreads();
  int kw = blockIdx.y;
  const int32_t* src = w.in[kw];
  int64_t head = (int64_t)(((16u - ((uintptr_t)src & 15u)) & 15u) >> 2);
  if (head > n) head = n;
  int64_t nv = (n - head) >> 2;
  const int4* body = (const int4*)(src + head);
  int64_t stride = (int64_t)gridDim.x * RS_THREADS;
  for (int64_t b = (int64_t)blockIdx.x * RS_THREADS; b < nv; b += stride) {
    int64_t i = b + threadIdx.x;
    bool ok = i < nv;
    int4 q = ok ? body[i] : make_int4(0, 0, 0, 0);
    count4(h[warp], (uint32_t)q.x ^ SIGN, ok);
    count4(h[warp], (uint32_t)q.y ^ SIGN, ok);
    count4(h[warp], (uint32_t)q.z ^ SIGN, ok);
    count4(h[warp], (uint32_t)q.w ^ SIGN, ok);
  }
  if (blockIdx.x == 0) {  // misaligned head and ragged tail: < 8 rows
    int64_t tail0 = head + 4 * nv;
    int64_t extra = head + (n - tail0);
    for (int64_t b = 0; b < extra; b += RS_THREADS) {
      int64_t j = b + threadIdx.x;
      bool ok = j < extra;
      int64_t i = j < head ? j : tail0 + (j - head);
      count4(h[warp], ok ? (uint32_t)src[i] ^ SIGN : 0u, ok);
    }
  }
  __syncthreads();
  int p0 = 4 * (n_keys - 1 - kw);
  for (int i = threadIdx.x; i < 4 * RS_BINS; i += RS_THREADS) {
    int32_t s = 0;
    for (int ww = 0; ww < RS_WARPS; ++ww) s += h[ww][i >> 8][i & 255];
    if (s) atomicAdd(&hist[(int64_t)(p0 + (i >> 8)) * RS_BINS + (i & 255)], s);
  }
}

// one block: digit bases and skip flag of every pass, then the run plan
__global__ void plan_kernel(const int32_t* __restrict__ hist, int n_keys,
                            int64_t n, int32_t* __restrict__ st) {
  __shared__ int32_t skip[RS_MAX_PASSES];
  int passes = 4 * n_keys;
  for (int p = 0; p < passes; ++p) {
    int32_t t = hist[p * RS_BINS + threadIdx.x];
    int32_t tot;
    int32_t incl = block_scan(t, &tot);
    st[ST_BASE + p * RS_BINS + threadIdx.x] = incl - t;
    int s = __syncthreads_or((int64_t)t == n);
    if (threadIdx.x == 0) {
      skip[p] = s;
      st[ST_SKIP + p] = s;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int cur = -1, first = -1, last = -1;
  for (int p = 0; p < passes; ++p) {
    st[ST_IN + p] = cur;
    st[ST_OUTB + p] = 0;
    st[ST_NEXTW + p] = -1;
    if (skip[p]) continue;
    int ob = cur < 0 ? 0 : cur ^ 1;
    st[ST_OUTB + p] = ob;
    cur = ob;
    if (first < 0) first = p;
    if (last >= 0) st[ST_NEXTW + last] = n_keys - 1 - p / 4;
    last = p;
  }
  st[ST_FIRST] = first;
  st[ST_LASTW] = last >= 0 ? n_keys - 1 - last / 4 : -1;
}

// One pass p of the large-n route. Every carried slot moves with the
// digit word: read once in tile order, written once in digit order. On the
// carry route slot s is word s; on the id route slot 0 holds the digit
// word and slot 1 the row ids, and the last pass of a key word writes the
// next key word gathered through the ids (w: the words, for those reads
// and for the first pass's digit word).
template <int ITEMS>
__global__ void __launch_bounds__(RS_THREADS, 3)
    pass_kernel(Slots sl, Words w, int n_slots, bool id_route, int n_keys,
                int64_t n, int p, const int32_t* __restrict__ st,
                uint32_t* counters, u64* status) {
  constexpr int TILE = ITEMS * RS_THREADS;
  if (st[ST_SKIP + p]) return;
  __shared__ int32_t wh[RS_WARPS][RS_BINS];
  __shared__ int32_t gofs[RS_BINS];
  __shared__ int32_t spos[TILE];
  __shared__ uint32_t sbuf[TILE];
  __shared__ int tile_sh;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) tile_sh = (int)atomicAdd(&counters[p], 1u);
  for (int d = lane; d < RS_BINS; d += 32) wh[warp][d] = 0;
  __syncthreads();
  const int tile = tile_sh;
  const int64_t tile0 = (int64_t)tile * TILE;
  const int word = n_keys - 1 - (p >> 2);
  const int shift = (p & 3) * 8;
  const int inb = st[ST_IN + p];
  const int nextw = st[ST_NEXTW + p];
  const bool last = nextw < 0;
  const int outb = st[ST_OUTB + p];
  const int vslot = id_route ? 0 : word;
  // id route, last pass of a key word: the next key word is gathered
  const bool gather_next = id_route && !last && nextw != word;
  const int64_t wbase = tile0 + (int64_t)warp * ITEMS * 32 + lane;

  uint32_t v[ITEMS];
  int lp[ITEMS];
  load_tile<ITEMS>(v,
                   inb < 0 ? (const uint32_t*)w.in[word] : sl.buf[inb][vslot],
                   wbase, n);
  // rank in row order within each warp's run
#pragma unroll
  for (int j = 0; j < ITEMS; ++j)
    lp[j] = warp_rank(wh[warp], ((v[j] ^ SIGN) >> shift) & 255u,
                      wbase + j * 32 < n);
  __syncthreads();

  // thread d: this tile's count of digit d, published at once
  const int d = threadIdx.x;
  int32_t c = 0;
  for (int ww = 0; ww < RS_WARPS; ++ww) c += wh[ww][d];
  const u64 tag = (u64)(p + 1) << 40;
  u64* my = status + (int64_t)tile * RS_BINS + d;
  st_release(my, tag | ((u64)(tile == 0 ? 2 : 1) << 32) | (uint32_t)c);
  int32_t tot;
  int32_t lstart = block_scan(c, &tot) - c;
  {
    int32_t run = lstart;
    for (int ww = 0; ww < RS_WARPS; ++ww) {
      int32_t x = wh[ww][d];
      wh[ww][d] = run;
      run += x;
    }
  }
  __syncthreads();
  // stage the digit word by digit
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    if (wbase + j * 32 < n) {
      lp[j] += wh[warp][((v[j] ^ SIGN) >> shift) & 255u];
      sbuf[lp[j]] = v[j];
    }
  }
  // decoupled look-back for digit d: four predecessors a round, read
  // relaxed (the count rides in the flag's own 64-bit word, so no other
  // data needs ordering), until one holds an inclusive prefix
  int64_t excl = 0;
  if (tile > 0) {
    int t = tile - 1;
    for (;;) {
      u64 sw[4];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sw[k] = t - k >= 0
                    ? ld_relaxed(status + (int64_t)(t - k) * RS_BINS + d)
                    : 0ull;
      int k = 0;
      bool done = false;
      for (; k < 4; ++k) {
        if ((sw[k] & (0xffull << 40)) != tag) break;   // not yet published
        excl += (uint32_t)sw[k];
        if (((sw[k] >> 32) & 3u) == 2u) {
          done = true;
          break;
        }
      }
      if (done) break;
      t -= k;
    }
    st_release(my, tag | (2ull << 32) | (uint32_t)(excl + c));
  }
  gofs[d] = st[ST_BASE + p * RS_BINS + d] + (int32_t)excl - lstart;
  __syncthreads();

  // write out: tile positions of one digit are consecutive global ones
  const int cnt = (int)(n - tile0 < TILE ? n - tile0 : TILE);
  uint32_t* vout = last ? (uint32_t*)w.out[word] : sl.buf[outb][vslot];
  for (int i = threadIdx.x; i < cnt; i += RS_THREADS) {
    uint32_t x = sbuf[i];
    int32_t pos = gofs[((x ^ SIGN) >> shift) & 255u] + i;
    spos[i] = pos;
    if (!gather_next) vout[pos] = x;
  }
  // every other slot: load in tile order, stage, write in digit order
  for (int s = 0; s < n_slots; ++s) {
    if (s == vslot) continue;
    uint32_t u[ITEMS];
    load_tile<ITEMS>(u, inb < 0 ? sl.src[s] : sl.buf[inb][s], wbase, n);
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (wbase + j * 32 < n) sbuf[lp[j]] = u[j];
    __syncthreads();
    uint32_t* dst = last ? sl.dst[s] : sl.buf[outb][s];
    for (int i = threadIdx.x; i < cnt; i += RS_THREADS)
      dst[spos[i]] = sbuf[i];
  }
  if (gather_next) {   // sbuf holds the row ids
    const uint32_t* nk = (const uint32_t*)w.in[nextw];
    for (int i = threadIdx.x; i < cnt; i += RS_THREADS)
      vout[spos[i]] = nk[sbuf[i]];
  }
}

// no pass ran: the outputs are the inputs, the permutation the iota
__global__ void identity_kernel(Words w, int m, int64_t n,
                                int32_t* __restrict__ perm,
                                const int32_t* __restrict__ st) {
  if (st[ST_FIRST] >= 0) return;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    for (int ww = 0; ww < m; ++ww) w.out[ww][i] = w.in[ww][i];
    if (perm) perm[i] = (int32_t)i;
  }
}

// out[i] = in[perm[i]] for the rows whose perm[i] lies in [lo, lo + win),
// for word w of the sort, unless the last pass wrote that word itself or
// no pass ran. One word and one window of source rows a launch: the
// random reads stay inside a window of 20 MB, which the L2 cache holds
// (the H100's 50 MB are two halves), and the ids stream past the cache
// (evict-first).
__global__ void gather_kernel(const int32_t* __restrict__ in,
                              int32_t* __restrict__ out, int w, int64_t n,
                              const int32_t* __restrict__ perm,
                              const int32_t* __restrict__ st, int64_t lo,
                              int64_t win) {
  if (st[ST_FIRST] < 0 || st[ST_LASTW] == w) return;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    int64_t id = __ldcs(perm + i);
    if (id >= lo && id < lo + win) out[i] = in[id];
  }
}

// n <= RS_SMALL_MAX: every pass in one block, row ids ping-ponged in
// shared memory, digits read through the ids; then the gather of up to
// RS_MAX_FUSED words and the permutation. Writes the skip flags.
__global__ void __launch_bounds__(RS_SMALL_THREADS)
    small_kernel(Words w, int m, int n_keys, int n,
                 int32_t* __restrict__ perm, int32_t* __restrict__ st) {
  extern __shared__ int32_t sm[];
  int32_t* ids0 = sm;
  int32_t* ids1 = ids0 + RS_SMALL_MAX;
  int32_t* rk = ids1 + RS_SMALL_MAX;
  int32_t(*wh)[RS_BINS] = (int32_t(*)[RS_BINS])(rk + RS_SMALL_MAX);
  uint8_t* dg = (uint8_t*)(&wh[RS_SMALL_WARPS][0]);
  __shared__ int32_t tot[RS_BINS];
  __shared__ int skip_sh;
  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  int seg = (((n + RS_SMALL_WARPS - 1) / RS_SMALL_WARPS) + 31) & ~31;
  for (int i = threadIdx.x; i < n; i += RS_SMALL_THREADS) ids0[i] = i;
  int32_t* cur = ids0;
  int32_t* nxt = ids1;
  for (int p = 0; p < 4 * n_keys; ++p) {
    const int32_t* key = w.in[n_keys - 1 - p / 4];
    int shift = (p & 3) * 8;
    for (int i = threadIdx.x; i < RS_SMALL_WARPS * RS_BINS;
         i += RS_SMALL_THREADS)
      (&wh[0][0])[i] = 0;
    __syncthreads();
    for (int j = 0; j < seg; j += 32) {
      int i = warp * seg + j + lane;
      bool ok = i < n;
      unsigned dd = ok ? (((uint32_t)key[cur[i]] ^ SIGN) >> shift) & 255u
                       : 0u;
      int r = warp_rank(wh[warp], dd, ok);
      if (ok) {
        rk[i] = r;
        dg[i] = (uint8_t)dd;
      }
    }
    __syncthreads();
    if (threadIdx.x < RS_BINS) {
      int32_t c = 0;
      for (int ww = 0; ww < RS_SMALL_WARPS; ++ww) c += wh[ww][threadIdx.x];
      tot[threadIdx.x] = c;
    }
    if (threadIdx.x == 0) skip_sh = 0;
    __syncthreads();
    if (threadIdx.x < 32) {   // exclusive scan of the 256 totals
      int32_t s = 0, loc[8];
      for (int k = 0; k < 8; ++k) {
        loc[k] = tot[lane * 8 + k];
        s += loc[k];
      }
      int32_t incl = s;
      for (int o = 1; o < 32; o <<= 1) {
        int32_t y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
      }
      int32_t run = incl - s;
      for (int k = 0; k < 8; ++k) {
        if (loc[k] == n) skip_sh = 1;
        tot[lane * 8 + k] = run;
        run += loc[k];
      }
    }
    __syncthreads();
    int skip = skip_sh;
    if (threadIdx.x == 0) st[ST_SKIP + p] = skip;
    if (skip) continue;
    if (threadIdx.x < RS_BINS) {
      int32_t run = tot[threadIdx.x];
      for (int ww = 0; ww < RS_SMALL_WARPS; ++ww) {
        int32_t x = wh[ww][threadIdx.x];
        wh[ww][threadIdx.x] = run;
        run += x;
      }
    }
    __syncthreads();
    for (int j = 0; j < seg; j += 32) {
      int i = warp * seg + j + lane;
      if (i < n) nxt[wh[warp][dg[i]] + rk[i]] = cur[i];
    }
    __syncthreads();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (threadIdx.x == 0) {   // for gather_kernel: every word past m
    st[ST_FIRST] = 0;
    st[ST_LASTW] = -1;
  }
  for (int i = threadIdx.x; i < n; i += RS_SMALL_THREADS) {
    int32_t id = cur[i];
    for (int ww = 0; ww < m; ++ww) w.out[ww][i] = w.in[ww][id];
    if (perm) perm[i] = id;
  }
}

// ---- host side ------------------------------------------------------------

// The route of a large sort: true for the id route. The estimate counts,
// per row, streaming word-passes (one 4-byte word read and written by a
// pass) at every pass a key word could take: the carry route moves every
// slot each pass; the id route moves 2 slots each pass plus a gather per
// key word after the first and per other word at the end, a gather costing
// about 4 word-passes (a random 4-byte read pulls a 32-byte sector).
static bool pick_id_route(int n_words, int n_keys, bool want_perm) {
  int passes = 4 * n_keys;
  int slots = (n_words < RS_MAX_KEYS ? n_words : RS_MAX_KEYS) +
              (want_perm || n_words > RS_MAX_KEYS ? 1 : 0);
  int gathers = (n_keys - 1) + (n_words - 1);
  return 2 * passes + 4 * gathers < slots * passes;
}

struct Layout {
  size_t zero, zero_bytes, hist, counters, status, bufs, perm, total;
  int n_slots, carried;   // slots of the large-n route; words among them
  bool id_route;
};

static size_t up256(size_t x) { return (x + 255) & ~(size_t)255; }

// route: -1 picks by the estimate above, 0 the carry route, 1 the id route
static Layout layout(int64_t n, int n_words, int n_keys, bool want_perm,
                     int route) {
  Layout L = {};
  size_t o = up256(ST_INTS * 4);
  size_t nb = up256((size_t)n * 4);
  L.perm = o;                 // row ids for the words gathered at the end
  if (n <= RS_SMALL_MAX) {
    if (!want_perm && n_words > RS_MAX_FUSED) o += nb;
    L.total = o;
    return L;
  }
  L.id_route = route < 0 ? pick_id_route(n_words, n_keys, want_perm)
                         : route == 1;
  if (L.id_route) {
    L.carried = 0;
    L.n_slots = 2;
    if (!want_perm) o += nb;
  } else {
    L.carried = n_words < RS_MAX_KEYS ? n_words : RS_MAX_KEYS;
    bool ids = want_perm || n_words > RS_MAX_KEYS;
    L.n_slots = L.carried + (ids ? 1 : 0);
    if (!want_perm && n_words > RS_MAX_KEYS) o += nb;
  }
  size_t ntiles = (size_t)((n + RS_TILE - 1) / RS_TILE);
  L.zero = o;
  L.hist = o;
  o += up256(RS_MAX_PASSES * RS_BINS * 4);
  L.counters = o;
  o += up256(RS_MAX_PASSES * 4);
  L.status = o;
  o += up256(ntiles * RS_BINS * 8);
  L.zero_bytes = o - L.zero;
  L.bufs = o;
  o += 2 * (size_t)L.n_slots * nb;
  L.total = o;
  return L;
}

static Words chunk(const int32_t* const* in, int32_t* const* out, int w0,
                   int m) {
  Words w = {};
  for (int i = 0; i < m; ++i) {
    w.in[i] = in[w0 + i];
    w.out[i] = out[w0 + i];
  }
  return w;
}

static int ew_blocks(int64_t n) {
  int64_t b = (n + RS_THREADS - 1) / RS_THREADS;
  return (int)(b < RS_EW_BLOCKS ? b : RS_EW_BLOCKS);
}

static int mini(int a, int b) { return a < b ? a : b; }

extern "C" int rf_radix_sort_tile(void) { return RS_TILE; }
extern "C" int rf_radix_sort_small_max(void) { return RS_SMALL_MAX; }
// offset (in int32) in the scratch of the per-pass skip flags; pass p
// sorts byte p % 4 of key word n_keys - 1 - p / 4
extern "C" int rf_radix_sort_skip_offset(void) { return ST_SKIP; }

// bytes of scratch rf_radix_sort_i32 needs for these arguments
extern "C" int64_t rf_radix_sort_scratch_bytes(int64_t n, int n_words,
                                               int n_keys, int want_perm,
                                               int route) {
  return (int64_t)layout(n, n_words, n_keys, want_perm != 0, route).total;
}

// words_in / words_out: host arrays of n_words device pointers to int32[n]
// (outputs must not alias inputs). perm_out: int32[n] for the permutation
// (sorted row i came from row perm_out[i]), or null. route: as for
// layout(). scratch: rf_radix_sort_scratch_bytes(...) bytes, 256-byte
// aligned. Returns the CUDA error code of the launches (0 on success).
extern "C" int rf_radix_sort_i32(const int32_t* const* words_in,
                                 int32_t* const* words_out, int n_words,
                                 int n_keys, int64_t n, int32_t* perm_out,
                                 int route, void* scratch, void* stream) {
  if (n <= 0) return 0;
  if (n_keys < 1 || n_keys > RS_MAX_KEYS || n_words < n_keys ||
      n >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Layout L = layout(n, n_words, n_keys, perm_out != nullptr, route);
  char* base = (char*)scratch;
  int32_t* st = (int32_t*)base;
  cudaStream_t s = (cudaStream_t)stream;
  int32_t* perm = perm_out ? perm_out : (int32_t*)(base + L.perm);
  int done;      // words written by the sort itself; the rest are gathered
  int eb = ew_blocks(n);
  int m0 = mini(n_words, RS_MAX_FUSED);
  Words w = chunk(words_in, words_out, 0, m0);
  cudaError_t e;

  if (n <= RS_SMALL_MAX) {
    done = m0;
    // per call: the attribute belongs to the current device
    e = cudaFuncSetAttribute(small_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMALL_SMEM);
    if (e != cudaSuccess) return (int)e;
    small_kernel<<<1, RS_SMALL_THREADS, SMALL_SMEM, s>>>(
        w, done, n_keys, (int)n, perm_out || n_words > done ? perm : nullptr,
        st);
  } else {
    done = L.carried;
    Slots sl = {};
    size_t nb = up256((size_t)n * 4);
    for (int i = 0; i < L.n_slots; ++i) {
      bool word = i < L.carried;
      sl.src[i] = word ? (const uint32_t*)words_in[i] : nullptr;
      sl.dst[i] = word ? (uint32_t*)words_out[i] : (uint32_t*)perm;
      for (int b = 0; b < 2; ++b)
        sl.buf[b][i] =
            (uint32_t*)(base + L.bufs + (size_t)(2 * i + b) * nb);
    }
    e = cudaMemsetAsync(base + L.zero, 0, L.zero_bytes, s);
    if (e != cudaSuccess) return (int)e;
    int32_t* hist = (int32_t*)(base + L.hist);
    uint32_t* counters = (uint32_t*)(base + L.counters);
    u64* status = (u64*)(base + L.status);
    int64_t hb = (n + RS_TILE - 1) / RS_TILE;
    dim3 hgrid((unsigned)(hb < RS_HIST_BLOCKS ? hb : RS_HIST_BLOCKS),
               (unsigned)n_keys);
    hist_kernel<<<hgrid, RS_THREADS, 0, s>>>(w, n_keys, n, hist);
    plan_kernel<<<1, RS_THREADS, 0, s>>>(hist, n_keys, n, st);
    unsigned ntiles = (unsigned)((n + RS_TILE - 1) / RS_TILE);
    for (int p = 0; p < 4 * n_keys; ++p)
      pass_kernel<RS_ITEMS><<<ntiles, RS_THREADS, 0, s>>>(
          sl, w, L.n_slots, L.id_route, n_keys, n, p, st, counters, status);
    for (int w0 = 0; w0 < n_words; w0 += RS_MAX_FUSED) {
      int m = mini(n_words - w0, RS_MAX_FUSED);
      identity_kernel<<<eb, RS_THREADS, 0, s>>>(
          chunk(words_in, words_out, w0, m), m, n,
          w0 == 0 && L.n_slots > L.carried ? perm : nullptr, st);
    }
  }
  int64_t nwin = (n + RS_GATHER_WINDOW - 1) / RS_GATHER_WINDOW;
  int64_t win = (n + nwin - 1) / nwin;
  for (int i = done; i < n_words; ++i)
    for (int64_t lo = 0; lo < n; lo += win)
      gather_kernel<<<eb, RS_THREADS, 0, s>>>(words_in[i], words_out[i], i,
                                              n, perm, st, lo, win);
  return (int)cudaGetLastError();
}
