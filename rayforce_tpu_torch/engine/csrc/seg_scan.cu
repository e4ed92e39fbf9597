// Inclusive segmented min / max / sum scan over runs of equal segment ids.
//
// Replaces the TPU package's `_seg_scan` (rayforce_tpu/engine/groupby.py),
// a jnp function under jax.jit with no Pallas: a two-level log doubling
// that the TPU needed because lax.cummax and associative_scan hang on
// that backend. Eager PyTorch runs that data flow as 135-141 launches
// (an eq, a where, the op and a full-length cat per doubling step); this
// file runs the same data flow in three launches.
//
// Contract: out[i] = op over the rows j <= i of i's run, where a row joins
// the scan of row i exactly as in the plain version (engine/groupby.py
// `seg_scan_plain`): ids are compared at the two ends of every doubling
// step, not through head flags, so unsorted ids give the plain version's
// answer too. Values are i32, i64 or f64, one lane or L lanes scanned on
// their own against shared ids (any row and lane stride); ids are i32 or
// i64 (any stride). `reverse` scans from each row to its run's end: it is
// the scan of the flipped arrays, flipped back, done by index arithmetic.
//
// Bit for bit. The kernels keep the plain version's data flow and operand
// order, so every f64 sum adds the same numbers in the same order:
//   block_pass  one block per 1024-row block (`_SEG_B`) and lane: a
//               Hillis-Steele doubling in shared memory, at d = 1 .. 512
//               m[j] = op(m[j], ids[j] == ids[j-d] ? m[j-d] : ident) for
//               j >= d. Pad rows past n have id -2 and the identity. Each
//               block's last value goes to the scratch (the block tails).
//   tail_pass   one block: the flags g[r] = (first id != last id of block
//               r) | joint[r] (joint[r]: block r's first id differs from
//               block r-1's last id; joint[0] = 1), then the same doubling
//               over the R block tails, cv[r] = g[r] ? cv[r]
//               : op(cv[r-d], cv[r]), g[r] |= g[r-d], ping-ponging two
//               buffers in global memory (R is about 29 300 at 3e7 rows).
//   fixup_pass  every row whose id equals its block's first id becomes
//               op(m, pfx), pfx = joint[r] ? ident : cv[r-1].
// The op is applied with the identity where the plain version does
// (-0.0 + 0.0 is +0.0). f64 min and max follow the rule of PyTorch's CUDA
// `minimum` / `maximum`, which the plain version runs on the card: a NaN
// operand is returned (the first if both are), else fmin / fmax; the f64
// sum is torch.add's fma (see apply). Integer sums wrap, as torch's do.
//
// Bound: memory. The yardstick is one read of the ids and the values and
// one write of the output, n * (id bytes + 2 * L * value bytes). This
// design reads the ids twice and the values once, writes the output once,
// and reads and writes again only the rows in their block's first run;
// the tail pass moves R * L values per doubling step in one block. On an
// H100 (80GB HBM3, 700 W) 1e7 rows take 0.26-0.29 ms against a bound of
// 0.036-0.060 ms, the one-block tail pass about a third of it.
//
// Scratch comes from the caller in one buffer (rf_seg_scan_scratch_bytes);
// every kernel runs on the caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define SS_B 1024          // rows of a block; the plain version's _SEG_B
#define SS_TAIL_THREADS 1024
#define SS_CHUNK 8         // items a tail-pass thread loads before it stores

enum { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2 };
enum { KIND_I32 = 0, KIND_I64 = 1, KIND_F64 = 2 };

// the kernels' names read seg_scan::... in a profile
namespace seg_scan {

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

// the arrays of one call, indexed by the LOGICAL row (the flipped row
// when reverse); rows past n are the plain version's pad
template <typename I, typename T> struct Args {
  const I* ids;
  int64_t id_stride;
  const T* vals;
  int64_t row_stride, lane_stride;
  T* out;                 // contiguous (n, lanes)
  int64_t n;
  int lanes, reverse;
  double one;             // 1.0, the f64 sum's alpha (see apply)

  __device__ __forceinline__ int64_t phys(int64_t i) const {
    return reverse ? n - 1 - i : i;
  }
  __device__ __forceinline__ int64_t id(int64_t i) const {
    return i < n ? (int64_t)ids[phys(i) * id_stride] : -2;
  }
};

template <typename I, typename T, int OP>
__global__ void __launch_bounds__(SS_B)
block_pass(Args<I, T> a, T* tails) {
  __shared__ int64_t sid[SS_B];
  __shared__ T sm[SS_B];
  const int j = threadIdx.x;
  const int lane = blockIdx.y;
  const int64_t row = (int64_t)blockIdx.x * SS_B + j;
  const int64_t id = a.id(row);
  T v = row < a.n ? a.vals[a.phys(row) * a.row_stride +
                           (int64_t)lane * a.lane_stride]
                  : ident<OP, T>();
  sid[j] = id;
  sm[j] = v;
  __syncthreads();
  for (int d = 1; d < SS_B; d <<= 1) {
    T nv = v;
    if (j >= d)
      nv = apply<OP>(v, sid[j - d] == id ? sm[j - d] : ident<OP, T>(),
                     a.one);
    __syncthreads();
    sm[j] = nv;
    v = nv;
    __syncthreads();
  }
  if (row < a.n) a.out[a.phys(row) * a.lanes + lane] = v;
  if (j == SS_B - 1) tails[(int64_t)blockIdx.x * a.lanes + lane] = v;
}

// block r's joint flag: its first id differs from block r-1's last id
template <typename I, typename T>
__device__ __forceinline__ bool joint(const Args<I, T>& a, int64_t r) {
  return r == 0 || a.id(r * SS_B) != a.id(r * SS_B - 1);
}

// One block. cv (R x lanes) holds the block tails and ping-pongs with cw;
// g and h are the flags' two buffers. The host knows from R which buffer
// ends with the scanned tails (rf_seg_scan's `steps`).
template <typename I, typename T, int OP>
__global__ void __launch_bounds__(SS_TAIL_THREADS)
tail_pass(Args<I, T> a, int64_t R, T* cv, T* cw, uint8_t* g, uint8_t* h) {
  const int t = threadIdx.x;
  const int64_t L = a.lanes;
  for (int64_t r = t; r < R; r += SS_TAIL_THREADS)
    g[r] = (a.id(r * SS_B) != a.id(r * SS_B + SS_B - 1)) || joint(a, r);
  __syncthreads();
  const int64_t total = R * L;
  for (int64_t d = 1; d < R; d <<= 1) {
    for (int64_t base = 0; base < total;
         base += (int64_t)SS_TAIL_THREADS * SS_CHUNK) {
      T x[SS_CHUNK], y[SS_CHUNK];
      bool keep[SS_CHUNK];
#pragma unroll
      for (int k = 0; k < SS_CHUNK; k++) {
        const int64_t i = base + (int64_t)k * SS_TAIL_THREADS + t;
        keep[k] = true;
        if (i < total) {
          const int64_t r = i / L;
          x[k] = cv[i];
          if (r >= d) {
            keep[k] = g[r];
            y[k] = cv[i - d * L];
          }
        }
      }
#pragma unroll
      for (int k = 0; k < SS_CHUNK; k++) {
        const int64_t i = base + (int64_t)k * SS_TAIL_THREADS + t;
        if (i < total)
          cw[i] = keep[k] ? x[k] : apply<OP>(y[k], x[k], a.one);
      }
    }
    for (int64_t r = t; r < R; r += SS_TAIL_THREADS)
      h[r] = r >= d ? (uint8_t)(g[r - d] | g[r]) : g[r];
    __syncthreads();
    T* tv = cv; cv = cw; cw = tv;
    uint8_t* tg = g; g = h; h = tg;
  }
}

template <typename I, typename T, int OP>
__global__ void __launch_bounds__(SS_B)
fixup_pass(Args<I, T> a, const T* cv) {
  const int64_t r = blockIdx.x;
  const int lane = blockIdx.y;
  const int64_t row = r * SS_B + threadIdx.x;
  if (row >= a.n) return;
  const int64_t first = a.id(r * SS_B);
  if (a.id(row) != first) return;
  const T pfx = joint(a, r) ? ident<OP, T>() : cv[(r - 1) * a.lanes + lane];
  T* o = a.out + a.phys(row) * a.lanes + lane;
  *o = apply<OP>(*o, pfx, a.one);
}

}  // namespace seg_scan

using namespace seg_scan;

static int64_t align256(int64_t x) { return (x + 255) & ~(int64_t)255; }

static int64_t blocks_of(int64_t n) { return (n + SS_B - 1) / SS_B; }

template <typename I, typename T, int OP>
static int run(Args<I, T> a, void* scratch, cudaStream_t s) {
  const int64_t R = blocks_of(a.n);
  const int64_t vb = align256(R * a.lanes * (int64_t)sizeof(T));
  const int64_t fb = align256(R);
  char* base = (char*)scratch;
  T* cv = (T*)base;
  T* cw = (T*)(base + vb);
  uint8_t* g = (uint8_t*)(base + 2 * vb);
  uint8_t* h = (uint8_t*)(base + 2 * vb + fb);
  dim3 grid((unsigned)R, (unsigned)a.lanes);
  block_pass<I, T, OP><<<grid, SS_B, 0, s>>>(a, cv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  int steps = 0;
  for (int64_t d = 1; d < R; d <<= 1) steps++;
  if (steps) {
    tail_pass<I, T, OP><<<1, SS_TAIL_THREADS, 0, s>>>(a, R, cv, cw, g, h);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  fixup_pass<I, T, OP><<<grid, SS_B, 0, s>>>(a, steps % 2 ? cw : cv);
  return (int)cudaGetLastError();
}

template <typename I, typename T>
static int run_op(Args<I, T> a, int op, void* scratch, cudaStream_t s) {
  switch (op) {
    case OP_MIN: return run<I, T, OP_MIN>(a, scratch, s);
    case OP_MAX: return run<I, T, OP_MAX>(a, scratch, s);
    case OP_SUM: return run<I, T, OP_SUM>(a, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename I>
static int run_vals(const I* ids, int64_t id_stride, const void* vals,
                    int val_kind, int64_t row_stride, int64_t lane_stride,
                    void* out, int64_t n, int lanes, int op, int reverse,
                    void* scratch, cudaStream_t s) {
#define SS_ARGS(T)                                                      \
  Args<I, T>{ids, id_stride, (const T*)vals, row_stride, lane_stride,  \
             (T*)out, n, lanes, reverse, 1.0}
  switch (val_kind) {
    case KIND_I32: return run_op(SS_ARGS(int32_t), op, scratch, s);
    case KIND_I64: return run_op(SS_ARGS(int64_t), op, scratch, s);
    case KIND_F64: return run_op(SS_ARGS(double), op, scratch, s);
  }
#undef SS_ARGS
  return (int)cudaErrorInvalidValue;
}

// rows of a block, which the plain version's _SEG_B must equal
extern "C" int rf_seg_scan_block(void) { return SS_B; }

// bytes of scratch rf_seg_scan needs for n rows of `lanes` lanes of
// val_bytes-byte values
extern "C" int64_t rf_seg_scan_scratch_bytes(int64_t n, int lanes,
                                             int val_bytes) {
  const int64_t R = blocks_of(n);
  return 2 * align256(R * lanes * (int64_t)val_bytes) + 2 * align256(R);
}

// The scan of n rows. ids: i32 (id_kind 0) or i64 (1) at id_stride
// elements a row; vals: i32 (val_kind 0), i64 (1) or f64 (2), lane l of
// row i at i * row_stride + l * lane_stride elements; out: the values'
// type, contiguous (n, lanes). op: 0 min, 1 max, 2 sum. Returns 0 or the
// cudaError of a launch.
extern "C" int rf_seg_scan(const void* ids, int id_kind, int64_t id_stride,
                           const void* vals, int val_kind,
                           int64_t row_stride, int64_t lane_stride,
                           void* out, int64_t n, int lanes, int op,
                           int reverse, void* scratch, void* stream) {
  if (n <= 0 || lanes <= 0) return 0;
  if (blocks_of(n) > INT32_MAX || lanes > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (id_kind) {
    case KIND_I32:
      return run_vals((const int32_t*)ids, id_stride, vals, val_kind,
                      row_stride, lane_stride, out, n, lanes, op, reverse,
                      scratch, s);
    case KIND_I64:
      return run_vals((const int64_t*)ids, id_stride, vals, val_kind,
                      row_stride, lane_stride, out, n, lanes, op, reverse,
                      scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}
