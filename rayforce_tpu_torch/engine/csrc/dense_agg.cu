// Dense per-code aggregates over a small code space: the dense plan's
// group-by (<= 512 codes, and every no-by select).
//
// Replaces the TPU package's `bcast_scan` (rayforce_tpu/engine/groupby.py:
// 168), a (65536, n) equality mask per chunk under lax.scan, and its
// `matmul_tasks_scan` (:89), exact sums as f32 one-hot MXU matmuls over
// 8-bit limbs: jnp under jax.jit, no Pallas, shaped by a TPU that has no
// fast scatter. The port's plain version (engine/groupby.py
// `dense_agg_plain`) is torch scatters over copies of the cells.
//
// Contract (the plain version's, lane for lane): codes in [0, W) (i32 or
// i64, any stride, 0 too); rows whose code lies outside are skipped. For
// every cell c:
//   counts[c]  the rows of code c (i64);
//   fidx[c]    the least row index, KEY_MAX for an empty cell;
//   lidx[c]    the greatest row index, -1 for an empty cell;
//   a DA_SUM lane (i32 or i64 values): the wrapping i64 sum;
//   a DA_MIN / DA_MAX lane (i32, i64 or f64 values): the least / greatest
//              value, min(init, ...) / max(init, ...) with init the losing
//              extreme of the type (f64: +-inf), f64 compared through its
//              order bits (psort.f64_order) so that -0.0 < 0.0 and NaN keeps
//              its place (a NaN with the sign bit clear above +inf, one with
//              it set below -inf);
//   a DA_FSUM lane (f64 values): the sum in the fixed order below, 0.0 for
//              an empty cell.
// Integer adds wrap and min / max are exact, so those lanes do not depend
// on the order in which rows meet: atomics in any order give the plain
// version's bits. An f64 sum depends on its order, so both versions add in
// one order, fixed by the row index alone (not the grid, the block count
// or the card), with no f64 atomics:
//   1. rows in chunks of DA_CHUNK; within a chunk each cell's partial is
//      the left fold of its rows in row order, from -0.0 (the exact
//      identity of IEEE addition: a cell of -0.0 rows stays -0.0);
//   2. the chunk partials of a cell combine by a pairwise tree over the
//      chunk index: level by level, node 2i + node 2i+1, an odd last node
//      passed up as it is (the tree padded with -0.0, without adding the
//      pads).
// Every f64 add is torch.add's, one fma(1.0, b, a) with `one` a kernel
// argument the compiler cannot fold (seg_scan.cu `apply`), so which NaN an
// inf - inf gives is the plain version's too.
//
// Design: two launches a call, dense_pass and dense_finish, and no
// memset. dense_pass: a persistent CTA of P <= DA_WARPS warps takes
// aligned groups of P chunks (group g, g + grid, ...), one warp a chunk,
// 32 * DA_UNROLL rows a step. Its cells sit in shared memory, each
// warp's own: a u64 word per cell for the count, fidx, lidx and every
// integer or extremum lane, a double per cell for every f64 sum. Every
// integer word is a wrapping u64 add or a u64 max that starts at 0: a
// max lane holds x ^ SIGN, a min lane its complement. A warp groups its
// 32 rows by code (__match_any_sync); the group's first lane counts it
// and offers its row to fidx, its last lane to lidx; a value lane whose
// 32 rows hold one code (every row of a no-by select) is reduced by
// shuffles, otherwise each group's first lane combines its members'
// words through the warp's stage; then that one lane updates the warp's
// word with a plain load and store. So the row loop has no atomics:
// 64-bit shared atomics are CAS loops on sm_90, and the lanes of one
// code would queue on one word. Where 8 warps' integer cells would not
// leave room for two CTAs an SM (many cells and lanes), the CTA shares
// one set and that lane updates it by an atomic instead (private_cells).
// f64 sums fold in the warp's own cells: the group's first lane folds
// its members in lane order, which is row order (32 rows of one code
// straight from the stage, every load ahead of the adds). At the end of
// a group the P chunk partials combine by the tree's first log2(P)
// levels in shared memory and the group's node goes to device memory.
// When a CTA is done it combines its warps' words and adds them to the
// call's global words with atomics.
// dense_finish: CTA b combines group nodes [DA_TREE b, DA_TREE (b + 1))
// by the tree into level 1's node b; the CTA that finishes last (a
// ticket after __threadfence) combines the levels above, DA_TREE nodes
// into one, up to the root, then writes every output in its type from
// the global words and the root, the empty cells' sentinels too, and
// zeroes the words and the ticket, so that the next call needs no
// memset. Folding dense_finish into dense_pass's last CTA (one launch a
// call) raised the pass's register pressure and cost its row loop more
// at 1e7 rows than the launch saves (PERF.md). The host asks for the
// shared-memory attribute and the occupancy once per kernel, device and
// size.
//
// Bound: memory. The yardstick is one read of the codes and of every lane
// and one write of the (W,) outputs. The kernel adds a reset and a
// combine of W words a warp and f64 lane per group of P chunks, writes
// and reads back a group's node (W words an f64 lane per P * 1024 rows),
// and a combine of every warp's words per CTA.
//
// Scratch comes from the caller in one buffer of rf_dense_agg_scratch_bytes
// whose first DA_ZERO_BYTES are zero, and are zero again when the call is
// done (the caller keeps one such buffer per stream); both launches run
// on the caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#define DA_CHUNK 1024          // rows a warp folds into one partial
#define DA_WARPS 8             // most warps (chunks) of a CTA, P
#define DA_UNROLL 4            // 32-row steps a lane loads at once
#define DA_TREE 32             // group nodes an aligned block combines
#define DA_MAX_LANES 24        // value lanes of one call
#define DA_SMEM 232448         // shared memory a block may use on sm_90
#define DA_CTAS_PER_SM 8       // most dense_pass CTAs an SM is given
#define DA_LEVELS 8            // most levels of group nodes
#define DA_FINISH_THREADS 256  // threads of a dense_finish CTA
#define DA_ZERO_BYTES 232704   // DA_SMEM + 256: the words and the ticket

static_assert(DA_ZERO_BYTES == DA_SMEM + 256, "the zeroed scratch");

enum { DA_SUM = 0, DA_MIN = 1, DA_MAX = 2, DA_FSUM = 3 };
enum { KIND_I32 = 0, KIND_I64 = 1, KIND_F64 = 2 };

#define FULL 0xFFFFFFFFu
#define SIGN 0x8000000000000000ULL

typedef unsigned long long u64;

// the kernels' names read dense_agg::... in a profile
namespace dense_agg {

struct Lane {
  const void* in;      // rows at `stride` elements
  void* out;           // (W,) of the output's type
  int64_t stride;
  int kind;            // KIND_*
  int op;              // DA_*
  int slot;            // the integer cell word, or the f64 sum's index
};

struct Params {
  const void* codes;
  int64_t code_stride;
  int64_t n;
  int W;               // cells
  int warps;           // P
  int n_lanes;
  int n_acc;           // integer words a cell: counts, fidx, lidx, lanes
  int n_f;             // f64 sum lanes
  int fidx;            // words 1 and 2 are fidx and lidx
  int levels;          // levels of group nodes (level 0: the groups)
  u64 add_slots;       // bit s: word s adds (else it takes the max)
  int64_t* counts;     // outputs or null
  int64_t* fidx_out;
  int64_t* lidx_out;
  u64* acc;            // (n_acc, W) global words, zero at the start
  unsigned* ticket;    // CTAs done, zero at the start
  double* nodes;       // group nodes, level after level, (level_n, n_f, W)
  int64_t level_n[DA_LEVELS];
  int64_t level_off[DA_LEVELS];  // in doubles
  double one;          // 1.0
  Lane lane[DA_MAX_LANES];
};

// a value's order word: signed i64 order = the value's order (f64
// through psort.f64_order's bits)
__device__ __forceinline__ long long order_of(const Lane& L, int64_t row) {
  if (L.kind == KIND_I32)
    return (long long)__ldg((const int*)L.in + row * L.stride);
  long long b = __ldg((const long long*)L.in + row * L.stride);
  if (L.kind == KIND_F64 && b < 0) b ^= 0x7FFFFFFFFFFFFFFFLL;
  return b;
}

// every cell word is a u64 add or a u64 max that starts at 0: a max
// lane holds x ^ SIGN, a min lane its complement
__device__ __forceinline__ u64 enc_max(long long x) { return (u64)x ^ SIGN; }
__device__ __forceinline__ u64 enc_min(long long x) {
  return ~((u64)x ^ SIGN);
}
__device__ __forceinline__ long long dec_max(u64 u) {
  return (long long)(u ^ SIGN);
}
__device__ __forceinline__ long long dec_min(u64 u) {
  return (long long)(~u ^ SIGN);
}

// the word a row adds to (or maxes into) its cell for an integer lane
__device__ __forceinline__ u64 word_of(const Lane& L, int64_t row) {
  long long x = order_of(L, row);
  if (L.op == DA_SUM) return (u64)x;
  return L.op == DA_MIN ? enc_min(x) : enc_max(x);
}

__device__ __forceinline__ void cell_op(u64* p, u64 v, bool add) {
  if (add)
    atomicAdd(p, v);
  else
    atomicMax(p, v);
}

__device__ __forceinline__ u64 warp_reduce(u64 v, bool add) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    u64 o = __shfl_xor_sync(FULL, v, d);
    v = add ? v + o : (o > v ? o : v);
  }
  return v;
}

template <typename C>
__device__ __forceinline__ int code_at(const Params& p, int64_t row) {
  long long c = (long long)__ldg((const C*)p.codes + row * p.code_stride);
  return (c >= 0 && c < p.W) ? (int)c : -1;
}

// a cell word's add or max: PRIV, the warp's own word, which one lane
// holds now (a load and a store); else the CTA's word (an atomic)
template <bool PRIV>
__device__ __forceinline__ void cell_put(u64* c, u64 v, bool add) {
  if constexpr (PRIV) {
    const u64 o = *c;
    *c = add ? o + v : (v > o ? v : o);
  } else {
    cell_op(c, v, add);
  }
}

// the tree over cnt <= DA_TREE nodes at base[k * stride], level by level,
// an odd last node passed up: a binary counter of blocks in registers
__device__ __forceinline__ double tree_of(const double* base,
                                          int64_t stride, int cnt,
                                          double one) {
  // every load issued before the first add (a node past cnt reads node
  // 0), by volatile loads that the compiler cannot sink into the adds'
  // branches one by one
  double v[DA_TREE];
#pragma unroll
  for (int k = 0; k < DA_TREE; ++k)
    asm volatile("ld.global.cg.f64 %0, [%1];"
                 : "=d"(v[k])
                 : "l"(base + (k < cnt ? k : 0) * stride));
  double blk[6];
#pragma unroll
  for (int k = 0; k < DA_TREE; ++k) {
    if (k < cnt) {
      double x = v[k];
      int lv = 0;
#pragma unroll
      for (; lv < 5 && ((k >> lv) & 1); ++lv) x = __fma_rn(one, x, blk[lv]);
      blk[lv] = x;
    }
  }
  double node = 0.0;
  bool have = false;
#pragma unroll
  for (int lv = 0; lv < 6; ++lv) {
    if ((cnt >> lv) & 1) {
      node = have ? __fma_rn(one, node, blk[lv]) : blk[lv];
      have = true;
    }
  }
  return node;
}

__device__ __forceinline__ long long init_of(int kind, int op) {
  if (kind == KIND_I32) return op == DA_MIN ? INT32_MAX : INT32_MIN;
  if (kind == KIND_I64) return op == DA_MIN ? INT64_MAX : INT64_MIN;
  // +inf; -inf's order word
  return op == DA_MIN ? 0x7FF0000000000000LL
                      : (long long)0xFFF0000000000000ULL ^
                            0x7FFFFFFFFFFFFFFFLL;
}

// the last CTA: every output in its type from the call's words and the
// root of the group nodes, the empty cells' sentinels too; the words
// zeroed again
__device__ void finish(const Params& p) {
  const int W = p.W;
  const int64_t WI = (int64_t)p.n_acc * W;
  const double* root = p.nodes + p.level_off[p.levels - 1];
  for (int c = threadIdx.x; c < W; c += blockDim.x) {
    const u64 cnt = __ldcg(p.acc + c);
    if (p.counts) p.counts[c] = (int64_t)cnt;
    if (p.fidx) {
      p.fidx_out[c] = dec_min(__ldcg(p.acc + W + c));
      const u64 l = __ldcg(p.acc + 2 * W + c), none = enc_max(-1);
      p.lidx_out[c] = dec_max(l > none ? l : none);
    }
    for (int l = 0; l < p.n_lanes; ++l) {
      const Lane& L = p.lane[l];
      if (L.op == DA_FSUM) {
        const double r = p.n ? __ldcg(root + (int64_t)L.slot * W + c) : -0.0;
        ((double*)L.out)[c] = cnt ? r : 0.0;
        continue;
      }
      const u64 u = __ldcg(p.acc + (int64_t)L.slot * W + c);
      long long x;
      if (L.op == DA_SUM) {
        x = (long long)u;
      } else if (L.op == DA_MIN) {
        const u64 i = enc_min(init_of(L.kind, L.op));
        x = dec_min(u > i ? u : i);
      } else {
        const u64 i = enc_max(init_of(L.kind, L.op));
        x = dec_max(u > i ? u : i);
      }
      if (L.op != DA_SUM && L.kind == KIND_I32) {
        ((int*)L.out)[c] = (int)x;
      } else {
        if (L.op != DA_SUM && L.kind == KIND_F64 && x < 0)
          x ^= 0x7FFFFFFFFFFFFFFFLL;
        ((long long*)L.out)[c] = x;
      }
    }
    for (int64_t i = c; i < WI; i += W) p.acc[i] = 0;
  }
}

template <typename C, bool PRIV>
__global__ void __launch_bounds__(32 * DA_WARPS)
dense_pass(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = p.W;
  const int64_t WI = (int64_t)p.n_acc * W, WF = (int64_t)p.n_f * W;
  u64* icell = (u64*)smem;                    // (P or 1, n_acc, W)
  double* fcell = (double*)(icell + (PRIV ? p.warps : 1) * WI);
  u64* stage = (u64*)(fcell + p.warps * WF);  // fcell (P, n_f, W); (P, 32)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  u64* mi = icell + (PRIV ? warp * WI : 0);
  double* mf = fcell + warp * WF;
  u64* sx = stage + warp * 32;
  double* sf = (double*)sx;

  if (PRIV) {
    for (int64_t i = lane; i < WI; i += 32) mi[i] = 0;
    __syncwarp();
  } else {
    for (int64_t i = threadIdx.x; i < WI; i += blockDim.x) mi[i] = 0;
    __syncthreads();
  }
  const int64_t chunks = (p.n + DA_CHUNK - 1) / DA_CHUNK;
  const int64_t groups = (chunks + p.warps - 1) / p.warps;
  for (int64_t g = blockIdx.x; g < groups; g += gridDim.x) {
    const int64_t chunk = g * p.warps + warp;
    for (int64_t i = lane; i < WF; i += 32) mf[i] = -0.0;
    __syncwarp();
    if (chunk < chunks) {
      const int64_t r1 = (chunk + 1) * DA_CHUNK < p.n
                             ? (chunk + 1) * DA_CHUNK : p.n;
      for (int64_t base = chunk * DA_CHUNK; base < r1;
           base += 32 * DA_UNROLL) {
        int key[DA_UNROLL];
        unsigned grp[DA_UNROLL];
#pragma unroll
        for (int u = 0; u < DA_UNROLL; ++u) {
          const int64_t row = base + u * 32 + lane;
          key[u] = row < r1 ? code_at<C>(p, row) : -1;
        }
#pragma unroll
        for (int u = 0; u < DA_UNROLL; ++u)
          grp[u] = __match_any_sync(FULL, key[u]);
        // counts and row ids: the group's first lane counts it and
        // offers its row to fidx, its last lane to lidx
#pragma unroll
        for (int u = 0; u < DA_UNROLL; ++u) {
          if (key[u] >= 0) {
            const int64_t row = base + u * 32 + lane;
            if (lane == __ffs(grp[u]) - 1) {
              cell_put<PRIV>(mi + key[u], (u64)__popc(grp[u]), true);
              if (p.fidx)
                cell_put<PRIV>(mi + W + key[u], enc_min(row), false);
            }
            if (p.fidx && lane == 31 - __clz(grp[u]))
              cell_put<PRIV>(mi + 2 * W + key[u], enc_max(row), false);
          }
          __syncwarp();
        }
        for (int l = 0; l < p.n_lanes; ++l) {
          const Lane& L = p.lane[l];
          if (L.op == DA_FSUM) {
            double v[DA_UNROLL];
#pragma unroll
            for (int u = 0; u < DA_UNROLL; ++u) {
              const int64_t row = base + u * 32 + lane;
              v[u] = key[u] >= 0 ? __ldg((const double*)L.in +
                                         row * L.stride)
                                 : 0.0;
            }
            double* fc = mf + (int64_t)L.slot * W;
#pragma unroll
            for (int u = 0; u < DA_UNROLL; ++u) {
              sf[lane] = v[u];
              __syncwarp();
              if (key[u] >= 0 && lane == __ffs(grp[u]) - 1) {
                double a = fc[key[u]];
                if (grp[u] == FULL) {
#pragma unroll 8
                  for (int i = 0; i < 32; ++i) a = __fma_rn(p.one, sf[i], a);
                } else {
                  for (unsigned m = grp[u]; m; m &= m - 1)
                    a = __fma_rn(p.one, sf[__ffs(m) - 1], a);
                }
                fc[key[u]] = a;
              }
              __syncwarp();
            }
          } else {
            u64 x[DA_UNROLL];
#pragma unroll
            for (int u = 0; u < DA_UNROLL; ++u) {
              const int64_t row = base + u * 32 + lane;
              x[u] = key[u] >= 0 ? word_of(L, row) : 0;
            }
            const bool add = L.op == DA_SUM;
            u64* c = mi + (int64_t)L.slot * W;
#pragma unroll
            for (int u = 0; u < DA_UNROLL; ++u) {
              if (grp[u] == FULL) {   // the same in every lane
                const u64 s = warp_reduce(x[u], add);
                if (lane == 0 && key[u] >= 0)
                  cell_put<PRIV>(c + key[u], s, add);
              } else {
                // the group's first lane combines its members' words
                sx[lane] = x[u];
                __syncwarp();
                if (key[u] >= 0 && lane == __ffs(grp[u]) - 1) {
                  u64 a = 0;
                  for (unsigned m = grp[u]; m; m &= m - 1) {
                    const u64 y = sx[__ffs(m) - 1];
                    a = add ? a + y : (y > a ? y : a);
                  }
                  cell_put<PRIV>(c + key[u], a, add);
                }
                __syncwarp();
              }
            }
          }
        }
      }
    }
    if (p.n_f) {
      // the tree's levels inside the group: node j + node j+s
      __syncthreads();
      for (int s = 1; s < p.warps; s <<= 1) {
        const int64_t pairs = p.warps / (2 * s);
        for (int64_t i = threadIdx.x; i < pairs * WF; i += blockDim.x) {
          const int j = (int)(i / WF) * 2 * s;
          const int64_t e = i % WF;
          if (g * p.warps + j + s < chunks)
            fcell[j * WF + e] =
                __fma_rn(p.one, fcell[(j + s) * WF + e], fcell[j * WF + e]);
        }
        __syncthreads();
      }
      for (int64_t i = threadIdx.x; i < WF; i += blockDim.x)
        p.nodes[g * WF + i] = fcell[i];
      __syncthreads();
    }
  }
  // the warps' cells into the CTA's, and those into the global ones
  __syncthreads();
  for (int64_t i = threadIdx.x; i < WI; i += blockDim.x) {
    const bool add = (p.add_slots >> (i / W)) & 1;
    u64 v = icell[i];
    for (int w = 1; PRIV && w < p.warps; ++w) {
      const u64 y = icell[w * WI + i];
      v = add ? v + y : (y > v ? y : v);
    }
    if (v) cell_op(&p.acc[i], v, add);
  }
}

// the second launch: CTA b combines group nodes [DA_TREE b, DA_TREE (b +
// 1)) by the tree into level 1's node b; the CTA that finishes last (a
// ticket after __threadfence) combines the levels above, DA_TREE nodes
// into one, up to the root, and writes every output (finish)
__global__ void __launch_bounds__(DA_FINISH_THREADS)
dense_finish(const __grid_constant__ Params p) {
  __shared__ int last;
  const int64_t WF = (int64_t)p.n_f * p.W;
  for (int lvl = 0; lvl + 1 < p.levels; ++lvl) {
    // level 0: this CTA's block; above it: every block, the last CTA
    const int64_t b0 = lvl ? 0 : blockIdx.x;
    const int64_t b1 = lvl ? p.level_n[lvl + 1] : b0 + 1;
    for (int64_t i = threadIdx.x; i < (b1 - b0) * WF; i += blockDim.x) {
      const int64_t b = b0 + i / WF, e = i % WF;
      const int64_t left = p.level_n[lvl] - b * DA_TREE;
      p.nodes[p.level_off[lvl + 1] + b * WF + e] = tree_of(
          p.nodes + p.level_off[lvl] + b * DA_TREE * WF + e, WF,
          left < DA_TREE ? (int)left : DA_TREE, p.one);
    }
    if (lvl == 0) {
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();   // the CTA's nodes, ordered by the barrier
        last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
        if (last) *p.ticket = 0;
        __threadfence();
      }
      __syncthreads();
      if (!last) return;
    } else {
      __syncthreads();
    }
  }
  finish(p);   // one CTA when there is one level
}

}  // namespace dense_agg

using namespace dense_agg;

// the shared memory of a dense_pass CTA of P warps: the integer cells of
// each warp (private) or of the CTA, and each warp's f64 cells and stage
static int64_t smem_of(int W, int n_acc, int n_f, int P, bool priv) {
  return 8 * ((int64_t)n_acc * W * (priv ? P : 1) +
              (int64_t)P * ((int64_t)n_f * W + 32));
}

// each warp keeps its own integer cells where DA_WARPS warps' cells leave
// room for two CTAs an SM (every dense shape of the main path: 101 cells
// or fewer); with more cells or lanes the CTA shares one set, updated by
// atomics
static bool private_cells(int W, int n_acc, int n_f) {
  return smem_of(W, n_acc, n_f, DA_WARPS, true) <= DA_SMEM / 2;
}

// warps of a dense_pass CTA: the most, up to DA_WARPS, whose cells fit;
// 0 if none does
static int warps_of(int W, int n_acc, int n_f, bool priv) {
  for (int P = DA_WARPS; P >= 1; P >>= 1)
    if (smem_of(W, n_acc, n_f, P, priv) <= DA_SMEM) return P;
  return 0;
}

struct Layout {
  bool priv;
  int P, levels;
  int64_t groups;
  int64_t level_n[DA_LEVELS], level_off[DA_LEVELS];
  int64_t total;   // scratch bytes
};

// the CTA's warps, the groups of n rows and the levels of group nodes
// above them (DA_TREE a node; none without f64 sums); false if the cells
// do not fit a CTA or the call needs more levels than DA_LEVELS
static bool layout(int64_t n, int W, int n_acc, int n_f, Layout* L) {
  L->priv = private_cells(W, n_acc, n_f);
  L->P = warps_of(W, n_acc, n_f, L->priv);
  if (!L->P) return false;
  const int64_t chunks = (n + DA_CHUNK - 1) / DA_CHUNK;
  L->groups = (chunks + L->P - 1) / L->P;
  const int64_t WF = (int64_t)n_f * W;
  int64_t g = n_f && L->groups > 0 ? L->groups : 1, off = 0;
  for (L->levels = 0;; g = (g + DA_TREE - 1) / DA_TREE) {
    if (L->levels == DA_LEVELS) return false;
    L->level_n[L->levels] = g;
    L->level_off[L->levels++] = off;
    off += g * WF;
    if (g == 1) break;
  }
  L->total = DA_ZERO_BYTES + 8 * off;
  return true;
}

// rows of a chunk, which the plain version's _DENSE_CHUNK must equal
extern "C" int rf_dense_agg_chunk(void) { return DA_CHUNK; }

// bytes of scratch rf_dense_agg needs for n rows over `cells` cells with
// n_acc integer words a cell (counts, fidx and lidx if asked, and every
// DA_SUM, DA_MIN and DA_MAX lane) and n_f DA_FSUM lanes; -1 if one CTA's
// cells do not fit in shared memory. Its first DA_ZERO_BYTES must be zero.
extern "C" int64_t rf_dense_agg_scratch_bytes(int64_t n, int cells,
                                              int n_acc, int n_f) {
  Layout L;
  if (n < 0 || cells < 1 || !layout(n, cells, n_acc, n_f, &L)) return -1;
  return L.total;
}

// kernel launches of one rf_dense_agg call: the pass (for n > 0) and the
// finish
extern "C" int rf_dense_agg_launches(int64_t n, int cells, int n_acc,
                                     int n_f) {
  return (n > 0 ? 1 : 0) + 1;
}

// the CTAs an SM holds of one dense_pass instance at `smem` bytes and
// `threads`, asked once per (instance, device, bytes, threads); the SMs
// of the device and the instance's shared-memory attribute (DA_SMEM),
// once per instance and device
struct Occ {
  const void* fn;
  int dev, threads;
  int64_t smem;
  int occ;
};
static std::mutex occ_mu;
static Occ occ_cache[128];
static int occ_used = 0;
static int sms_of[64];
static bool attr_set[64][4];

template <typename C, bool PRIV>
static int occupancy(int64_t smem, int threads, int* occ, int* sms) {
  const void* fn = (const void*)dense_pass<C, PRIV>;
  const int ti = (sizeof(C) == 8) * 2 + PRIV;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> g(occ_mu);
  if (!attr_set[dev][ti]) {
    e = cudaFuncSetAttribute(dense_pass<C, PRIV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DA_SMEM);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms_of[dev],
                               cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev][ti] = true;
  }
  *sms = sms_of[dev];
  for (int i = 0; i < occ_used; ++i)
    if (occ_cache[i].fn == fn && occ_cache[i].dev == dev &&
        occ_cache[i].smem == smem && occ_cache[i].threads == threads) {
      *occ = occ_cache[i].occ;
      return 0;
    }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      occ, dense_pass<C, PRIV>, threads, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  const Occ o = {fn, dev, threads, smem, *occ};
  occ_cache[occ_used < 128 ? occ_used++ : (int)(smem % 128)] = o;
  return 0;
}

template <typename C, bool PRIV>
static int launch(const Params& p, int64_t groups, cudaStream_t s) {
  if (groups > 0) {
    const int64_t smem = smem_of(p.W, p.n_acc, p.n_f, p.warps, PRIV);
    int occ = 0, sms = 0;
    const int rc = occupancy<C, PRIV>(smem, 32 * p.warps, &occ, &sms);
    if (rc) return rc;
    if (occ <= 0) return (int)cudaErrorInvalidConfiguration;
    const int64_t most =
        (int64_t)sms * (occ < DA_CTAS_PER_SM ? occ : DA_CTAS_PER_SM);
    const int64_t ctas = groups < most ? groups : most;
    dense_pass<C, PRIV><<<(unsigned)ctas, 32 * p.warps, (size_t)smem, s>>>(
        p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = p.levels > 1 ? p.level_n[1] : 1;
  dense_finish<<<(unsigned)blocks, DA_FINISH_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// The aggregates of n rows over `cells` cells. codes: i32 (code_kind 0) or
// i64 (1) at code_stride elements a row. Lane i: values at ins[i], row r at
// r * strides[i] elements, of kinds[i] (0 i32, 1 i64, 2 f64) under ops[i]
// (0 sum of i32 / i64 into i64, 1 min, 2 max, 3 f64 sum), written to
// outs[i] as (cells,) of i64 (op 0), f64 (op 3) or the values' type. counts,
// fidx and lidx: (cells,) i64 outputs, each null when not wanted (fidx and
// lidx together). scratch: rf_dense_agg_scratch_bytes, its first
// DA_ZERO_BYTES zero (and zero again after the call). The launches of
// rf_dense_agg_launches, no memset. Returns 0 or the cudaError of a
// launch; cudaErrorInvalidValue for arguments it does not take.
extern "C" int rf_dense_agg(const void* codes, int code_kind,
                            int64_t code_stride, int64_t n, int cells,
                            int n_lanes, const void* const* ins,
                            const int64_t* strides, const int* kinds,
                            const int* ops, void* const* outs, void* counts,
                            void* fidx, void* lidx, void* scratch,
                            void* stream) {
  if (n < 0 || cells < 1 || n_lanes < 0 || n_lanes > DA_MAX_LANES ||
      (code_kind != KIND_I32 && code_kind != KIND_I64) ||
      (fidx == nullptr) != (lidx == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Params p = {};
  p.codes = codes;
  p.code_stride = code_stride;
  p.n = n;
  p.W = cells;
  p.fidx = fidx != nullptr;
  p.counts = (int64_t*)counts;
  p.fidx_out = (int64_t*)fidx;
  p.lidx_out = (int64_t*)lidx;
  p.one = 1.0;
  p.n_lanes = n_lanes;
  int n_acc = p.fidx ? 3 : 1, n_f = 0;
  p.add_slots = 1;   // counts
  for (int i = 0; i < n_lanes; ++i) {
    const int op = ops[i], kind = kinds[i];
    const bool ok = op == DA_SUM ? (kind == KIND_I32 || kind == KIND_I64)
                  : op == DA_FSUM ? kind == KIND_F64
                  : (op == DA_MIN || op == DA_MAX) &&
                        (kind >= KIND_I32 && kind <= KIND_F64);
    if (!ok) return (int)cudaErrorInvalidValue;
    Lane& L = p.lane[i];
    L.in = ins[i];
    L.out = outs[i];
    L.stride = strides[i];
    L.kind = kind;
    L.op = op;
    if (op == DA_FSUM) {
      L.slot = n_f++;
    } else {
      if (op == DA_SUM) p.add_slots |= 1ULL << n_acc;
      L.slot = n_acc++;
    }
  }
  p.n_acc = n_acc;
  p.n_f = n_f;
  Layout lay;
  if (!layout(n, cells, n_acc, n_f, &lay))
    return (int)cudaErrorInvalidValue;
  p.warps = lay.P;
  p.levels = lay.levels;
  for (int l = 0; l < lay.levels; ++l) {
    p.level_n[l] = lay.level_n[l];
    p.level_off[l] = lay.level_off[l];
  }
  char* base = (char*)scratch;
  p.acc = (u64*)base;
  p.ticket = (unsigned*)(base + DA_SMEM);
  p.nodes = (double*)(base + DA_ZERO_BYTES);
  if (code_kind == KIND_I32)
    return lay.priv ? launch<int32_t, true>(p, lay.groups, s)
                    : launch<int32_t, false>(p, lay.groups, s);
  return lay.priv ? launch<long long, true>(p, lay.groups, s)
                  : launch<long long, false>(p, lay.groups, s);
}
