// Inclusive segmented min / max / sum scan over runs of equal segment ids.
//
// Replaces the TPU package's `_seg_scan` (rayforce_tpu/engine/groupby.py),
// a jnp function under jax.jit with no Pallas: a two-level log doubling
// that the TPU needed because lax.cummax and associative_scan hang on
// that backend. Eager PyTorch runs that data flow as 135-141 launches
// (an eq, a where, the op and a full-length cat per doubling step).
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
// The plain version's data flow, which every route below reproduces:
//   1. in each 1024-row block (`_SEG_B`), a Hillis-Steele doubling at
//      d = 1 .. 512: m[j] = op(m[j], ids[j] == ids[j-d] ? m[j-d] : ident)
//      for j >= d; pad rows past n have id -2 and the identity;
//   2. over the R block tails cv[r] (block r's last m), the flagged
//      doubling cv[r] = g[r] ? cv[r] : op(cv[r-d], cv[r]), g[r] |= g[r-d],
//      with g[r] = (block r's first id != its last id) | joint[r] and
//      joint[r] = (block r's first id != block r-1's last id), joint[0] = 1;
//   3. every row whose id equals its block's first id becomes op(m, pfx),
//      pfx = joint[r] ? ident : cv[r-1].
//
// block_pass runs step 1 with one warp per block: lane l holds rows
// 32 k + l, k < 32, so d = 1 .. 16 are register shuffles inside the warp
// and d = 32 .. 512 are register steps inside each lane (item k takes item
// k - d / 32). Every step applies the same op to the same operands as the
// plain version, so an f64 sum adds the same numbers in the same order.
// The route after that is chosen on the host from the value type and R
// (rf_seg_scan_route), never by retrying:
//
//   lookback     integer values (i32, i64; min, max and the wrapping sum).
//                Step 2 is a head-flagged segmented scan of the tails, and
//                these ops are exact, associative and commutative, so it
//                equals the chain c[r] = g[r] ? cv[r] : op(c[r-1], cv[r])
//                bit for bit. One launch (after a memset of its look-back
//                words): each CTA takes its blocks from an atomic counter;
//                a block whose ids never turn back (sorted, either way; the
//                main path's) has contiguous runs, so its step 1 is each
//                run's own scan (exact ops again), done in blocked layout
//                through shared memory, and its tail, the last run's total,
//                is published before that scan (as the inclusive c[r] when
//                g[r] is set, else as an aggregate); any other block takes
//                the doubling. The warp then reads back over its
//                predecessors' words 32 at a time until a g block or an
//                inclusive one, publishes c[r], applies step 3 to its rows
//                in registers and writes each row once.
//   shared_tail  f64 values where a lane's R tails and flags fit in shared
//                memory (R * 9 bytes <= SS_TAIL_SMEM): step 2's exact
//                doubling tree, one block per lane, in place in shared
//                memory (waves from the top so that a read always sees the
//                step's old value), then fixup_pass.
//   global_tail  f64 values with more blocks (R > 25 827, about 26.4e6
//                rows): step 2 in one block, ping-ponging two buffers in
//                global memory, then fixup_pass.
//
// f64 min and max follow PyTorch's CUDA `minimum` / `maximum`, which the
// plain version runs on the card: a NaN operand is returned (the first if
// both are), else fmin / fmax; the f64 sum is torch.add's fma (see apply).
// The op is applied with the identity where the plain version applies it
// (-0.0 + 0.0 is +0.0), and skipped only where that is the identity on
// every bit pattern (integers; f64 min and max). Integer sums wrap, as
// torch's do. So the f64 routes keep the doubling and the tail tree, with
// their order and the NaN that min and max return; the integer route may
// associate in any order.
//
// block_pass also writes each block's summary word for the f64 routes: g,
// joint, and the length of the block's leading run of first-id rows, with
// a flag if a later row has the first id too (unsorted ids). fixup_pass
// reads and writes only those rows; it reads ids only in flagged blocks.
//
// Bound: memory. The yardstick is one read of the ids and the values and
// one write of the output, n * (id bytes + 2 * L * value bytes). The
// integer route moves that plus R look-back words; the f64 routes add a
// read and a write of each block's first run. Ids stay in registers
// across the lanes of a block, so (n, L) values read them once. What
// holds the integer route off its bound is the look-back: a block whose
// predecessor's data came later waits with its registers held, and so
// with fewer loads in flight (PERF.md, section 6).
//
// Scratch comes from the caller in one buffer (rf_seg_scan_scratch_bytes);
// every launch runs on the caller's stream and nothing synchronises.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#define SS_B 1024             // rows of a block; the plain version's _SEG_B
#define SS_ITEMS 32           // rows a lane holds: SS_B / 32
#define SS_WARPS 4            // warps (blocks) of a block_pass CTA
#define SS_MIN_CTAS 2         // block_pass CTAs an SM holds: 255 registers
#define SS_TAIL_THREADS 1024
#define SS_CHUNK 8            // items a tail-pass thread loads before it stores
#define SS_TAIL_SMEM 232448   // shared memory a block may use on sm_90
#define SS_COUNTER_BYTES 256  // the look-back's block counter

enum { OP_MIN = 0, OP_MAX = 1, OP_SUM = 2 };
enum { KIND_I32 = 0, KIND_I64 = 1, KIND_F64 = 2 };
enum { ROUTE_LOOKBACK = 0, ROUTE_SHARED_TAIL = 1, ROUTE_GLOBAL_TAIL = 2 };

// look-back status words: nothing yet, the block's tail alone (g unset),
// the inclusive c[r]
enum { ST_NONE = 0, ST_AGG = 1, ST_INC = 2 };

// summary word of a block (f64 routes): bits 0-10 the leading run's length
#define SW_LEAD 0x7FFu
#define SW_G (1u << 11)
#define SW_JOINT (1u << 12)
#define SW_SCATTERED (1u << 13)

#define FULL 0xFFFFFFFFu

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

// a read-only load through the non-coherent cache
template <typename T>
__device__ __forceinline__ T ldg(const T* p) {
  if constexpr (sizeof(T) == 8 && std::is_integral<T>::value)
    return (T)__ldg((const long long*)p);
  else
    return __ldg(p);
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
  __device__ __forceinline__ I id(int64_t i) const {
    return i < n ? ldg(ids + phys(i) * id_stride) : (I)-2;
  }
};

// The scratch of one call (R blocks, L lanes, vb-byte values) holds what
// its route uses, each region 256-byte aligned:
//   lookback     R x L look-back words (a status and a value, 2 x vb
//                bytes) and the block counter, zeroed together
//   shared_tail  R summary words (4 bytes), the R x L block tails
//   global_tail  the same, the tails' second buffer and 2 x R flag bytes
struct Layout {
  int64_t words, counter, a, b, g, total;
};

static int64_t align256(int64_t x) { return (x + 255) & ~(int64_t)255; }

static int64_t blocks_of(int64_t n) { return (n + SS_B - 1) / SS_B; }

// the route of a scan of n rows of val_kind values
static int route_of(int64_t n, int val_kind) {
  if (val_kind != KIND_F64) return ROUTE_LOOKBACK;
  return blocks_of(n) * (int64_t)(sizeof(double) + 1) <= SS_TAIL_SMEM
             ? ROUTE_SHARED_TAIL
             : ROUTE_GLOBAL_TAIL;
}

static Layout layout(int64_t n, int lanes, int val_kind) {
  const int64_t R = blocks_of(n);
  const int64_t vb = val_kind == KIND_I32 ? 4 : 8;
  const int route = route_of(n, val_kind);
  Layout L;
  L.words = 0;
  if (route == ROUTE_LOOKBACK) {
    L.counter = align256(R * lanes * 2 * vb);
    L.a = L.b = L.g = L.total = L.counter + SS_COUNTER_BYTES;
  } else {
    L.counter = L.a = align256(R * 4);
    L.b = L.g = L.total = L.a + align256(R * lanes * vb);
    if (route == ROUTE_GLOBAL_TAIL) {
      L.g = L.b + align256(R * lanes * vb);
      L.total = L.g + align256(2 * R);
    }
  }
  return L;
}

// A look-back word: a block's status and its value for one lane of
// values, in one aligned word twice the value's width, written and read
// whole by one thread (8 bytes, or 16 for 64-bit values as one vector
// access, as CUB's tile states do), so that a reader never sees a status
// without its value. The accesses go to L2 (.cg), where every SM sees
// them; asm volatile keeps a spinning read in the loop.
template <typename T> struct Word;
template <> struct Word<int32_t> {
  typedef unsigned long long W;
  static __device__ __forceinline__ void put(W* p, unsigned st, int32_t v) {
    const W w = ((W)st << 32) | (unsigned)v;
    asm volatile("st.global.cg.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
  }
  static __device__ __forceinline__ W get(const W* p) {
    W w;
    asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
    return w;
  }
  static __device__ __forceinline__ W make(unsigned st, int32_t v) {
    return ((W)st << 32) | (unsigned)v;
  }
  static __device__ __forceinline__ unsigned status(W w) {
    return (unsigned)(w >> 32);
  }
  static __device__ __forceinline__ int32_t value(W w) {
    return (int32_t)(unsigned)w;
  }
};
template <> struct Word<int64_t> {
  typedef longlong2 W;   // x: status, y: value
  static __device__ __forceinline__ void put(W* p, unsigned st, int64_t v) {
    asm volatile("st.global.cg.v2.s64 [%0], {%1, %2};" ::"l"(p),
                 "l"((long long)st), "l"((long long)v)
                 : "memory");
  }
  static __device__ __forceinline__ W get(const W* p) {
    W w;
    asm volatile("ld.global.cg.v2.s64 {%0, %1}, [%2];"
                 : "=l"(w.x), "=l"(w.y)
                 : "l"(p)
                 : "memory");
    return w;
  }
  static __device__ __forceinline__ W make(unsigned st, int64_t v) {
    return make_longlong2(st, v);
  }
  static __device__ __forceinline__ unsigned status(W w) {
    return (unsigned)w.x;
  }
  static __device__ __forceinline__ int64_t value(W w) { return w.y; }
};

// The look-back of lane lv: lane l of the warp reads the word of block
// top - l, 32 blocks a round, until a block that holds its inclusive c.
// `first_round` starts it: it reads the first round's words, so that the
// caller can scan its own block while they come. look_back waits for the
// words in front of the nearest inclusive one and folds them into c[top]
// (integer ops only: the fold's order is free).
template <typename T>
__device__ __forceinline__ typename Word<T>::W first_round(
    const typename Word<T>::W* words, int64_t top, int lanes, int lv,
    int l) {
  const int64_t k = top - l;
  // before block 0 there is nothing: an inclusive identity
  return k >= 0 ? Word<T>::get(words + k * lanes + lv)
                : Word<T>::make(ST_INC, (T)0);
}

template <typename T, int OP>
__device__ T look_back(const typename Word<T>::W* words,
                       typename Word<T>::W w, int64_t top, int lanes, int lv,
                       int l) {
  T acc = ident<OP, T>();
  for (;;) {
    const int64_t k = top - l;
    const typename Word<T>::W* p = words + (k >= 0 ? k : 0) * lanes + lv;
    unsigned incl;
    for (;;) {
      const unsigned st = Word<T>::status(w);
      incl = __ballot_sync(FULL, st == ST_INC);
      const unsigned none = __ballot_sync(FULL, st == ST_NONE);
      const unsigned before = incl ? (incl & (0u - incl)) - 1 : FULL;
      if (!(none & before)) break;
      if (st == ST_NONE) w = Word<T>::get(p);
    }
    const int stop = incl ? __ffs(incl) - 1 : 32;
    T x = k >= 0 && l <= stop ? Word<T>::value(w) : ident<OP, T>();
#pragma unroll
    for (int o = 16; o; o >>= 1)
      x = apply<OP>(x, __shfl_xor_sync(FULL, x, o), 1.0);
    acc = apply<OP>(acc, x, 1.0);
    if (incl) return acc;
    top -= 32;
    w = first_round<T>(words, top, lanes, lv, l);
  }
}

// Step 1 on the rows 32 k + l (k < 32) that lane l of a warp holds: the
// plain version's doubling, operand for operand, at d = 2^s:
// m[j] = op(m[j], ids[j] == ids[j-d] ? m[j-d] : ident) for j >= d.
template <typename I, typename T, int OP>
__device__ __forceinline__ void double_block(T (&m)[SS_ITEMS],
                                             const I (&id)[SS_ITEMS], int l,
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
    for (int k = SS_ITEMS - 1; k >= 0; k--) {
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
    for (int k = SS_ITEMS - 1; k >= 0; k--)
      if (k >= e)
        m[k] = apply<OP>(m[k], id[k >= e ? k - e : 0] == id[k]
                                   ? m[k >= e ? k - e : 0]
                                   : ident<OP, T>(),
                         one);
  }
}

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
__device__ __forceinline__ void run_scan(T (&m)[SS_ITEMS], T* sv,
                                         unsigned heads, int l) {
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++) sv[pad(32 * k + l)] = m[k];
  __syncwarp();
  T v[SS_ITEMS];
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++) v[k] = sv[pad(32 * l + k)];
#pragma unroll
  for (int k = 1; k < SS_ITEMS; k++)
    if (!((heads >> k) & 1)) v[k] = apply<OP>(v[k - 1], v[k], 1.0);
  int f = heads != 0;
  T x = v[SS_ITEMS - 1];
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
  const int lead = heads ? __ffs(heads) - 1 : SS_ITEMS;
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++) {
    if (l > 0 && k < lead) v[k] = apply<OP>(carry, v[k], 1.0);
    sv[pad(32 * l + k)] = v[k];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++) m[k] = sv[pad(32 * k + l)];
  __syncwarp();
}

// Step 1 of the look-back route for a block whose ids turn back: the
// ids and lane lv's values loaded again, the doubling, and the doubled
// rows left in the warp's shared buffer `sv` (striped). Not inlined, so
// that its registers do not weigh on the common path.
template <typename I, typename T, int OP>
__device__ __noinline__ void double_from_memory(const Args<I, T> a,
                                                int64_t base, int lv,
                                                T* sv) {
  const int l = threadIdx.x & 31;
  const int64_t rem = a.n - base;
  const int64_t p0 = a.phys(base + l);
  const int64_t dir = a.reverse ? -32 : 32;
  I id[SS_ITEMS];
  T m[SS_ITEMS];
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++) {
    const bool in = 32 * k + l < rem;
    id[k] = in ? ldg(a.ids + (p0 + k * dir) * a.id_stride) : (I)-2;
    m[k] = in ? ldg(a.vals + (p0 + k * dir) * a.row_stride +
                    lv * a.lane_stride)
              : ident<OP, T>();
  }
  double_block<I, T, OP>(m, id, l, a.one);
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++) sv[pad(32 * k + l)] = m[k];
  __syncwarp();
}

// One warp per 1024-row block (step 1 of the header, then the route's
// part of steps 2 and 3), the lanes of values one after another against
// ids read once. LOOK: the integer look-back route, a CTA's blocks taken
// from `counter`, `lb` its look-back words; otherwise the f64 routes'
// first launch, which writes the doubled rows, the tails (`A`) and the
// summary words.
template <typename I, typename T, int OP, bool LOOK>
__global__ void __launch_bounds__(32 * SS_WARPS, SS_MIN_CTAS)
block_pass(Args<I, T> a, int64_t R, uint32_t* words, void* lb,
           uint32_t* counter, T* A) {
  const int l = threadIdx.x & 31;
  int64_t r;
  if constexpr (LOOK) {
    __shared__ unsigned cta;
    if (threadIdx.x == 0) cta = atomicAdd(counter, 1u);
    __syncthreads();
    r = (int64_t)cta * SS_WARPS + threadIdx.x / 32;
  } else {
    r = (int64_t)blockIdx.x * SS_WARPS + threadIdx.x / 32;
  }
  if (r >= R) return;
  const int64_t base = r * SS_B;
  // item k is row base + l + 32 k: valid below `rem`, at physical row
  // p0 + 32 k * dir
  const int64_t rem = a.n - base;
  const int64_t p0 = a.phys(base + l);
  const int64_t dir = a.reverse ? -32 : 32;
  const I* ip = a.ids + p0 * a.id_stride;
  const int64_t istep = dir * a.id_stride;
  const int64_t vstep = dir * a.row_stride;

  I id[SS_ITEMS];
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++)
    id[k] = 32 * k + l < rem ? ldg(ip + k * istep) : (I)-2;
  // 64-bit values of the look-back route load after the ids have been
  // read, so that the two arrays never fill the registers at once
  constexpr bool late = LOOK && sizeof(T) == 8;
  T m[SS_ITEMS];
  if (!late) {
#pragma unroll
    for (int k = 0; k < SS_ITEMS; k++)
      m[k] = 32 * k + l < rem ? ldg(a.vals + p0 * a.row_stride + k * vstep)
                              : ident<OP, T>();
  }
  const I first = __shfl_sync(FULL, id[0], 0);
  const I last = __shfl_sync(FULL, id[SS_ITEMS - 1], 31);
  const bool joint = r == 0 || first != a.id(base - 1);
  const bool g = joint || first != last;
  unsigned fmask = 0;   // the rows step 3 touches: bit k for row 32 k + l
#pragma unroll
  for (int k = 0; k < SS_ITEMS; k++) fmask |= (id[k] == first ? 1u : 0u) << k;

  if constexpr (LOOK) {
    typedef typename Word<T>::W W;
    W* wp = (W*)lb;
    __shared__ T sbuf[SS_WARPS][SS_B + 32];
    // row 32 k + l - 1 (lane l - 1's item k, or lane 31's item k - 1): do
    // the ids turn back below row n, and where do runs start?
    bool up = true, down = true;
    unsigned hs = 0;
    int last_head = 0;
#pragma unroll
    for (int k = 0; k < SS_ITEMS; k++) {
      const I si = l == 31 && k > 0 ? id[k > 0 ? k - 1 : 0] : id[k];
      const I p = __shfl_sync(FULL, si, (l - 1) & 31);
      const int row = 32 * k + l;
      if (row > 0 && row < rem) {
        up &= p <= id[k];
        down &= p >= id[k];
      }
      if (row == 0 || p != id[k]) {
        hs |= 1u << k;
        last_head = row;
      }
    }
    const bool mono = __all_sync(FULL, up) || __all_sync(FULL, down);
    // blocked heads (bit k: row 32 l + k starts a run), one ballot an
    // item, and the last run's first row
    unsigned heads = 0;
#pragma unroll
    for (int k = 0; k < SS_ITEMS; k++) {
      const unsigned b = __ballot_sync(FULL, (hs >> k) & 1);
      if (l == k) heads = b;
    }
    const int from = (int)__reduce_max_sync(FULL, (unsigned)last_head);

    for (int lv = 0; lv < a.lanes; lv++) {
      if (lv > 0 || late) {
#pragma unroll
        for (int k = 0; k < SS_ITEMS; k++)
          m[k] = 32 * k + l < rem
                     ? ldg(a.vals + p0 * a.row_stride + lv * a.lane_stride +
                           k * vstep)
                     : ident<OP, T>();
      }
      W* mine = wp + r * a.lanes + lv;
      T tail;
      W w;
      if (mono) {
        // the tail is the last run's total: publish it, start reading the
        // predecessors' words, then scan
        T x = ident<OP, T>();
#pragma unroll
        for (int k = 0; k < SS_ITEMS; k++)
          if (32 * k + l >= from) x = apply<OP>(x, m[k], 1.0);
#pragma unroll
        for (int o = 16; o; o >>= 1)
          x = apply<OP>(x, __shfl_xor_sync(FULL, x, o), 1.0);
        tail = x;
        if (l == 0) Word<T>::put(mine, g ? ST_INC : ST_AGG, tail);
        if (!joint) w = first_round<T>(wp, r - 1, a.lanes, lv, l);
        run_scan<T, OP>(m, sbuf[threadIdx.x / 32], heads, l);
      } else {
        if (!joint) w = first_round<T>(wp, r - 1, a.lanes, lv, l);
        T* sv = sbuf[threadIdx.x / 32];
        double_from_memory<I, T, OP>(a, base, lv, sv);
#pragma unroll
        for (int k = 0; k < SS_ITEMS; k++) m[k] = sv[pad(32 * k + l)];
        __syncwarp();
        tail = __shfl_sync(FULL, m[SS_ITEMS - 1], 31);
        if (l == 0) Word<T>::put(mine, g ? ST_INC : ST_AGG, tail);
      }
      if (!joint) {
        const T pfx = look_back<T, OP>(wp, w, r - 1, a.lanes, lv, l);
        if (!g && l == 0)
          Word<T>::put(mine, ST_INC, apply<OP>(pfx, tail, a.one));
#pragma unroll
        for (int k = 0; k < SS_ITEMS; k++)
          if ((fmask >> k) & 1) m[k] = apply<OP>(m[k], pfx, a.one);
      }
      T* o = a.out + p0 * a.lanes + lv;
      const int64_t ostep = dir * a.lanes;
#pragma unroll
      for (int k = 0; k < SS_ITEMS; k++)
        if (32 * k + l < rem) o[k * ostep] = m[k];
    }
  } else {
    // the first run: its leading rows, and whether any row after them
    // has the first id too
    unsigned lead = SS_B;
#pragma unroll
    for (int k = SS_ITEMS - 1; k >= 0; k--)
      if (!((fmask >> k) & 1)) lead = 32 * k + l;
    lead = __reduce_min_sync(FULL, lead);
    bool scat = false;
#pragma unroll
    for (int k = 0; k < SS_ITEMS; k++)
      scat |= ((fmask >> k) & 1) && (unsigned)(32 * k + l) > lead;
    if (__any_sync(FULL, scat) && l == 0) lead |= SW_SCATTERED;
    if (l == 0)
      words[r] = lead | (g ? SW_G : 0u) | (joint ? SW_JOINT : 0u);

    for (int lv = 0; lv < a.lanes; lv++) {
      if (lv > 0) {
#pragma unroll
        for (int k = 0; k < SS_ITEMS; k++)
          m[k] = 32 * k + l < rem
                     ? ldg(a.vals + p0 * a.row_stride + lv * a.lane_stride +
                           k * vstep)
                     : ident<OP, T>();
      }
      double_block<I, T, OP>(m, id, l, a.one);
      if (l == 31) A[r * a.lanes + lv] = m[SS_ITEMS - 1];
      T* o = a.out + p0 * a.lanes + lv;
      const int64_t ostep = dir * a.lanes;
#pragma unroll
      for (int k = 0; k < SS_ITEMS; k++)
        if (32 * k + l < rem) o[k * ostep] = m[k];
    }
  }
}

// Step 2 for one lane (blockIdx.x) in shared memory: the R tails and
// their flags, doubled in place. Each step runs in waves of
// SS_TAIL_THREADS * SS_CHUNK tails from the top: a wave reads its own
// tails and those below it, then writes its own, so every read sees the
// step's old value.
template <typename I, typename T, int OP>
__global__ void __launch_bounds__(SS_TAIL_THREADS)
tail_shared(Args<I, T> a, int64_t R, const uint32_t* words, T* cv) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* sv = (T*)smem;
  uint8_t* sg = smem + R * sizeof(T);
  const int t = threadIdx.x;
  const int lv = blockIdx.x;
  const int64_t L = a.lanes;
  for (int64_t r = t; r < R; r += SS_TAIL_THREADS) {
    sv[r] = cv[r * L + lv];
    sg[r] = (words[r] & SW_G) ? 1 : 0;
  }
  __syncthreads();
  const int64_t W = (int64_t)SS_TAIL_THREADS * SS_CHUNK;
  for (int64_t d = 1; d < R; d <<= 1) {
    for (int64_t top = (R - 1) / W * W; top >= 0; top -= W) {
      T x[SS_CHUNK], y[SS_CHUNK];
      bool keep[SS_CHUNK];
      uint8_t gn[SS_CHUNK];
#pragma unroll
      for (int c = 0; c < SS_CHUNK; c++) {
        const int64_t i = top + (int64_t)c * SS_TAIL_THREADS + t;
        keep[c] = true;
        if (i < R) {
          x[c] = sv[i];
          gn[c] = sg[i];
          if (i >= d) {
            keep[c] = sg[i];
            y[c] = sv[i - d];
            gn[c] |= sg[i - d];
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < SS_CHUNK; c++) {
        const int64_t i = top + (int64_t)c * SS_TAIL_THREADS + t;
        if (i < R) {
          sv[i] = keep[c] ? x[c] : apply<OP>(y[c], x[c], a.one);
          sg[i] = gn[c];
        }
      }
      __syncthreads();
    }
  }
  for (int64_t r = t; r < R; r += SS_TAIL_THREADS) cv[r * L + lv] = sv[r];
}

// Step 2 in one block, all lanes, in global memory. cv (R x lanes) holds
// the block tails and ping-pongs with cw; g and h are the flags' two
// buffers. The host knows from R which buffer ends with the scanned tails
// (run's `steps`).
template <typename I, typename T, int OP>
__global__ void __launch_bounds__(SS_TAIL_THREADS)
tail_global(Args<I, T> a, int64_t R, const uint32_t* words, T* cv, T* cw,
            uint8_t* g, uint8_t* h) {
  const int t = threadIdx.x;
  const int64_t L = a.lanes;
  for (int64_t r = t; r < R; r += SS_TAIL_THREADS)
    g[r] = (words[r] & SW_G) ? 1 : 0;
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

// Step 3 for the f64 routes, one warp per block: the rows of the block's
// first run that its summary word names, each lane by its prefix.
template <typename I, typename T, int OP>
__global__ void __launch_bounds__(32 * SS_WARPS)
fixup_pass(Args<I, T> a, int64_t R, const uint32_t* words, const T* cv) {
  const int64_t r = (int64_t)blockIdx.x * SS_WARPS + threadIdx.x / 32;
  const int l = threadIdx.x & 31;
  if (r >= R) return;
  const uint32_t w = words[r];
  // op(m, ident) is m on every bit pattern for min and max
  if ((w & SW_JOINT) && OP != OP_SUM) return;
  const int lead = (int)(w & SW_LEAD);
  const int end = (w & SW_SCATTERED) ? SS_B : lead;
  const int64_t base = r * SS_B;
  const I first = (w & SW_SCATTERED) ? a.id(base) : (I)0;
  for (int j = l; j < end; j += 32) {
    const int64_t i = base + j;
    if (i >= a.n) break;
    if (j >= lead && a.id(i) != first) continue;
    T* o = a.out + a.phys(i) * a.lanes;
    for (int lv = 0; lv < a.lanes; lv++) {
      const T pfx = (w & SW_JOINT) ? ident<OP, T>()
                                   : cv[(r - 1) * a.lanes + lv];
      o[lv] = apply<OP>(o[lv], pfx, a.one);
    }
  }
}

}  // namespace seg_scan

using namespace seg_scan;

template <typename I, typename T, int OP>
static int run(Args<I, T> a, int val_kind, void* scratch, cudaStream_t s) {
  const int64_t R = blocks_of(a.n);
  const Layout L = layout(a.n, a.lanes, val_kind);
  char* base = (char*)scratch;
  uint32_t* words = (uint32_t*)(base + L.words);
  T* A = (T*)(base + L.a);
  T* B = (T*)(base + L.b);
  const unsigned ctas = (unsigned)((R + SS_WARPS - 1) / SS_WARPS);
  const int route = route_of(a.n, val_kind);
  cudaError_t e;
  if constexpr (std::is_integral<T>::value) {
    if (route != ROUTE_LOOKBACK) return (int)cudaErrorInvalidValue;
    e = cudaMemsetAsync(base, 0, L.total, s);
    if (e != cudaSuccess) return (int)e;
    block_pass<I, T, OP, true><<<ctas, 32 * SS_WARPS, 0, s>>>(
        a, R, words, base + L.words, (uint32_t*)(base + L.counter), A);
    return (int)cudaGetLastError();
  } else {
    if (route == ROUTE_LOOKBACK) return (int)cudaErrorInvalidValue;
    block_pass<I, T, OP, false><<<ctas, 32 * SS_WARPS, 0, s>>>(
        a, R, words, nullptr, nullptr, A);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const T* tails = A;
    if (R > 1 && route == ROUTE_SHARED_TAIL) {
      const int smem = (int)(R * (int64_t)(sizeof(T) + 1));
      e = cudaFuncSetAttribute(tail_shared<I, T, OP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
      if (e != cudaSuccess) return (int)e;
      tail_shared<I, T, OP><<<(unsigned)a.lanes, SS_TAIL_THREADS, smem, s>>>(
          a, R, words, A);
    } else if (R > 1) {
      int steps = 0;
      for (int64_t d = 1; d < R; d <<= 1) steps++;
      uint8_t* g = (uint8_t*)(base + L.g);
      tail_global<I, T, OP><<<1, SS_TAIL_THREADS, 0, s>>>(
          a, R, words, A, B, g, g + R);
      if (steps % 2) tails = B;
    }
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    fixup_pass<I, T, OP><<<ctas, 32 * SS_WARPS, 0, s>>>(a, R, words, tails);
    return (int)cudaGetLastError();
  }
}

template <typename I, typename T>
static int run_op(Args<I, T> a, int val_kind, int op, void* scratch,
                  cudaStream_t s) {
  switch (op) {
    case OP_MIN: return run<I, T, OP_MIN>(a, val_kind, scratch, s);
    case OP_MAX: return run<I, T, OP_MAX>(a, val_kind, scratch, s);
    case OP_SUM: return run<I, T, OP_SUM>(a, val_kind, scratch, s);
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
    case KIND_I32:
      return run_op(SS_ARGS(int32_t), val_kind, op, scratch, s);
    case KIND_I64:
      return run_op(SS_ARGS(int64_t), val_kind, op, scratch, s);
    case KIND_F64:
      return run_op(SS_ARGS(double), val_kind, op, scratch, s);
  }
#undef SS_ARGS
  return (int)cudaErrorInvalidValue;
}

// rows of a block, which the plain version's _SEG_B must equal
extern "C" int rf_seg_scan_block(void) { return SS_B; }

// bytes of scratch rf_seg_scan needs for n rows of `lanes` lanes of
// val_kind values: its route's regions
extern "C" int64_t rf_seg_scan_scratch_bytes(int64_t n, int lanes,
                                             int val_kind) {
  return layout(n, lanes, val_kind).total;
}

// the route rf_seg_scan takes for n rows of val_kind values, however
// many lanes (the shared tail holds one lane's tails at a time):
// 0 lookback, 1 shared_tail, 2 global_tail
extern "C" int rf_seg_scan_route(int64_t n, int val_kind) {
  return route_of(n, val_kind);
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
  if (blocks_of(n) > INT32_MAX) return (int)cudaErrorInvalidValue;
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
