// Stable LSD radix sort of M parallel int32 words by their first n_keys
// words, compared as a signed-i32 lexicographic key, ascending.
//
// Replaces the TPU package's blocked bitonic sort: both of its
// pl.pallas_call sites (rayforce_tpu/engine/psort.py, `_block_kernel`
// launched from `_sort_padded` for phase A, `_window_pass_kernel` for
// phase B). The TPU chose a data-oblivious bitonic network because it has
// no fast scatter; Hopper scatters well, so this is the reference C
// engine's own algorithm instead (an LSD radix sort of row indices,
// rayforce core/sort.c).
//
// Design. The key words are sorted from the last to the first; each word
// takes four 8-bit passes over (digit value, row index) pairs held in two
// ping-pong buffers. A pass is
//   hist_kernel        per-tile digit counts, digit-major [256][ntiles];
//   digit_scan_kernel  one block per digit: exclusive scan of its row of
//                      tile counts, and the digit's total;
//   advance_kernel     exclusive scan of the 256 totals (digit bases);
//                      a pass whose digit is the same in every row is an
//                      identity and is skipped;
//   scatter_kernel     stable scatter of one 8192-row tile: each warp owns
//                      a contiguous run and ranks equal digits with
//                      __match_any_sync, so equal keys keep their row
//                      order; the tile is ordered by digit in shared
//                      memory first, so the writes to device memory are
//                      runs of consecutive addresses.
// Which buffer holds the current data (it changes only when a pass is not
// skipped) lives in device memory, so that nothing waits for the host.
// Before each key word but the last-sorted one, gather_key_kernel reads
// that word through the current permutation. At the end gather_kernel
// applies the permutation to every word (keys and payload).
//
// Bound: memory. Per key word and pass it reads 4 B per row for the
// histogram, 4 + 8 B per row in the scatter and writes 8 B per row; the
// final gather reads and writes 4 B per row per word. The least any sort
// could move is one read and one write of every word (2 * n * M * 4 B).
// No padding and no guard word: any n works.
//
// Scratch buffers come from the caller (PyTorch's caching allocator);
// every kernel runs on the caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#define RS_THREADS 256                    // every kernel's block size
#define RS_WARPS (RS_THREADS / 32)
#define RS_TILE 8192                      // rows per scatter tile
#define RS_SEG (RS_TILE / RS_WARPS)       // rows per warp
#define RS_BINS 256
#define RS_EW_BLOCKS 4096                 // grid cap for elementwise kernels
#define RS_MAX_KEYS 16
#define RS_MAX_PASSES (4 * RS_MAX_KEYS)

// device state (int32), laid out in one caller-provided buffer
#define ST_BASE 0                         // [256] digit bases of this pass
#define ST_TOT (ST_BASE + RS_BINS)        // [256] digit totals of this pass
#define ST_PAR (ST_TOT + RS_BINS)         // [passes + 1] buffer holding data
#define ST_SKIP (ST_PAR + RS_MAX_PASSES + 1)  // [passes] pass skipped
#define ST_INTS (ST_SKIP + RS_MAX_PASSES)

#define SCATTER_SMEM \
  ((RS_WARPS * RS_BINS + RS_BINS + 2 * RS_TILE) * (int)sizeof(int32_t))

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

// first key word: (word with its sign bit flipped, row index) into buffer 0
__global__ void init_kernel(const int32_t* __restrict__ key,
                            uint32_t* __restrict__ val,
                            int32_t* __restrict__ perm, int64_t n,
                            int32_t* __restrict__ st) {
  if (blockIdx.x == 0 && threadIdx.x == 0) st[ST_PAR] = 0;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    val[i] = (uint32_t)key[i] ^ 0x80000000u;
    perm[i] = (int32_t)i;
  }
}

// a later key word, read through the permutation of pass p
__global__ void gather_key_kernel(const int32_t* __restrict__ key,
                                  uint32_t* va, uint32_t* vb,
                                  const int32_t* pa, const int32_t* pb,
                                  int64_t n, const int32_t* __restrict__ st,
                                  int p) {
  int par = st[ST_PAR + p];
  const int32_t* perm = par ? pb : pa;
  uint32_t* val = par ? vb : va;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    val[i] = (uint32_t)key[perm[i]] ^ 0x80000000u;
  }
}

__global__ void gather_kernel(const int32_t* __restrict__ src,
                              const int32_t* pa, const int32_t* pb,
                              int32_t* __restrict__ dst, int64_t n,
                              const int32_t* __restrict__ st, int p) {
  const int32_t* perm = st[ST_PAR + p] ? pb : pa;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    dst[i] = src[perm[i]];
  }
}

__global__ void hist_kernel(const uint32_t* va, const uint32_t* vb,
                            int64_t n, int shift,
                            int32_t* __restrict__ counts, int ntiles,
                            const int32_t* __restrict__ st, int p) {
  __shared__ int32_t h[RS_BINS];
  const uint32_t* val = st[ST_PAR + p] ? vb : va;
  h[threadIdx.x] = 0;
  __syncthreads();
  int64_t base = (int64_t)blockIdx.x * RS_TILE;
  int64_t end = base + RS_TILE < n ? base + RS_TILE : n;
  for (int64_t i = base + threadIdx.x; i < end; i += RS_THREADS)
    atomicAdd(&h[(val[i] >> shift) & (RS_BINS - 1)], 1);
  __syncthreads();
  counts[(int64_t)threadIdx.x * ntiles + blockIdx.x] = h[threadIdx.x];
}

// block d: exclusive scan of counts[d][0..ntiles) in place, total to st
__global__ void digit_scan_kernel(int32_t* __restrict__ counts, int ntiles,
                                  int32_t* __restrict__ st) {
  int32_t* row = counts + (int64_t)blockIdx.x * ntiles;
  int32_t carry = 0;
  for (int c = 0; c < ntiles; c += RS_THREADS) {
    int i = c + threadIdx.x;
    int32_t v = i < ntiles ? row[i] : 0;
    int32_t tot;
    int32_t incl = block_scan(v, &tot);
    if (i < ntiles) row[i] = carry + incl - v;
    carry += tot;
  }
  if (threadIdx.x == 0) st[ST_TOT + blockIdx.x] = carry;
}

// one block: digit bases, and whether pass p is an identity
__global__ void advance_kernel(int32_t* __restrict__ st, int p, int64_t n) {
  int32_t t = st[ST_TOT + threadIdx.x];
  int32_t tot;
  int32_t incl = block_scan(t, &tot);
  st[ST_BASE + threadIdx.x] = incl - t;
  int skip = __syncthreads_or((int64_t)t == n);
  if (threadIdx.x == 0) {
    st[ST_SKIP + p] = skip;
    st[ST_PAR + p + 1] = st[ST_PAR + p] ^ (skip ? 0 : 1);
  }
}

__global__ void scatter_kernel(uint32_t* va, uint32_t* vb, int32_t* pa,
                               int32_t* pb, int64_t n, int shift,
                               const int32_t* __restrict__ counts,
                               int ntiles, const int32_t* __restrict__ st,
                               int p) {
  if (st[ST_SKIP + p]) return;
  extern __shared__ int32_t smem[];
  int32_t(*wh)[RS_BINS] = (int32_t(*)[RS_BINS])smem;   // [warp][digit]
  int32_t* gofs = smem + RS_WARPS * RS_BINS;           // [digit]
  uint32_t* sval = (uint32_t*)(gofs + RS_BINS);        // [tile]
  int32_t* sperm = (int32_t*)(sval + RS_TILE);         // [tile]

  int par = st[ST_PAR + p];
  const uint32_t* val_in = par ? vb : va;
  const int32_t* perm_in = par ? pb : pa;
  uint32_t* val_out = par ? va : vb;
  int32_t* perm_out = par ? pa : pb;

  int warp = threadIdx.x >> 5;
  int lane = threadIdx.x & 31;
  for (int w = 0; w < RS_WARPS; ++w) wh[w][threadIdx.x] = 0;
  __syncthreads();
  int64_t tile0 = (int64_t)blockIdx.x * RS_TILE;
  int64_t base = tile0 + (int64_t)warp * RS_SEG;
  unsigned lt = (1u << lane) - 1u;

  // pass 1: per-warp digit counts of this warp's run
  for (int j = 0; j < RS_SEG; j += 32) {
    int64_t i = base + j + lane;
    bool ok = i < n;
    unsigned d = ok ? (val_in[i] >> shift) & (RS_BINS - 1) : RS_BINS + lane;
    unsigned peers = __match_any_sync(0xffffffffu, d);
    int leader = 31 - __clz(peers);
    if (ok && lane == leader) wh[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // tile-local start of each (warp, digit) run, and the shift from a
  // tile-local position to the global one for each digit
  {
    int d = threadIdx.x;
    int32_t tt = 0;
    for (int w = 0; w < RS_WARPS; ++w) tt += wh[w][d];
    int32_t total;
    int32_t lstart = block_scan(tt, &total) - tt;
    int32_t run = lstart;
    for (int w = 0; w < RS_WARPS; ++w) {
      int32_t c = wh[w][d];
      wh[w][d] = run;
      run += c;
    }
    gofs[d] = st[ST_BASE + d] + counts[(int64_t)d * ntiles + blockIdx.x] -
              lstart;
  }
  __syncthreads();
  // pass 2: order the tile by digit in shared memory (stable)
  for (int j = 0; j < RS_SEG; j += 32) {
    int64_t i = base + j + lane;
    bool ok = i < n;
    uint32_t v = ok ? val_in[i] : 0u;
    unsigned d = ok ? (v >> shift) & (RS_BINS - 1) : RS_BINS + lane;
    unsigned peers = __match_any_sync(0xffffffffu, d);
    int leader = 31 - __clz(peers);
    int32_t rank = ok ? wh[warp][d] + __popc(peers & lt) : 0;
    __syncwarp();
    if (ok && lane == leader) wh[warp][d] += __popc(peers);
    __syncwarp();
    if (ok) {
      sval[rank] = v;
      sperm[rank] = perm_in[i];
    }
  }
  __syncthreads();
  // write out: consecutive tile positions of one digit are consecutive
  // global positions
  int cnt = (int)(n - tile0 < RS_TILE ? n - tile0 : RS_TILE);
  for (int i = threadIdx.x; i < cnt; i += RS_THREADS) {
    uint32_t v = sval[i];
    int64_t pos = (int64_t)gofs[(v >> shift) & (RS_BINS - 1)] + i;
    val_out[pos] = v;
    perm_out[pos] = sperm[i];
  }
}

static int ew_blocks(int64_t n) {
  int64_t b = (n + RS_THREADS - 1) / RS_THREADS;
  return (int)(b < RS_EW_BLOCKS ? b : RS_EW_BLOCKS);
}

extern "C" int rf_radix_sort_tile(void) { return RS_TILE; }
extern "C" int rf_radix_sort_state_ints(void) { return ST_INTS; }
// offset in the state of the per-pass skip flags; pass p sorts byte p % 4
// of key word n_keys - 1 - p / 4
extern "C" int rf_radix_sort_skip_offset(void) { return ST_SKIP; }

// words_in / words_out: host arrays of n_words device pointers to int32[n]
// (outputs must not alias inputs). Scratch: perm_a, perm_b, val_a, val_b
// of n int32 each, counts of RS_BINS * ceil(n / RS_TILE) int32, state of
// rf_radix_sort_state_ints() int32. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int rf_radix_sort_i32(const int32_t* const* words_in,
                                 int32_t* const* words_out, int n_words,
                                 int n_keys, int64_t n, int32_t* perm_a,
                                 int32_t* perm_b, int32_t* val_a,
                                 int32_t* val_b, int32_t* counts,
                                 int32_t* state, void* stream) {
  if (n <= 0) return 0;
  if (n_keys < 1 || n_keys > RS_MAX_KEYS || n_words < n_keys)
    return (int)cudaErrorInvalidValue;
  // per call: the attribute belongs to the current device, and a call
  // costs little next to the sort
  cudaError_t e = cudaFuncSetAttribute(
      scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SCATTER_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  int ntiles = (int)((n + RS_TILE - 1) / RS_TILE);
  int eb = ew_blocks(n);
  uint32_t* va = (uint32_t*)val_a;
  uint32_t* vb = (uint32_t*)val_b;
  int p = 0;
  for (int kw = n_keys - 1; kw >= 0; --kw) {
    if (kw == n_keys - 1)
      init_kernel<<<eb, RS_THREADS, 0, s>>>(words_in[kw], va, perm_a, n,
                                            state);
    else
      gather_key_kernel<<<eb, RS_THREADS, 0, s>>>(
          words_in[kw], va, vb, perm_a, perm_b, n, state, p);
    for (int shift = 0; shift < 32; shift += 8, ++p) {
      hist_kernel<<<ntiles, RS_THREADS, 0, s>>>(va, vb, n, shift, counts,
                                                ntiles, state, p);
      digit_scan_kernel<<<RS_BINS, RS_THREADS, 0, s>>>(counts, ntiles,
                                                       state);
      advance_kernel<<<1, RS_THREADS, 0, s>>>(state, p, n);
      scatter_kernel<<<ntiles, RS_THREADS, SCATTER_SMEM, s>>>(
          va, vb, perm_a, perm_b, n, shift, counts, ntiles, state, p);
    }
  }
  for (int w = 0; w < n_words; ++w)
    gather_kernel<<<eb, RS_THREADS, 0, s>>>(words_in[w], perm_a, perm_b,
                                            words_out[w], n, state, p);
  return (int)cudaGetLastError();
}
