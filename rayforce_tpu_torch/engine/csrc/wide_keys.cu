// The wide engine's group-key words (engine/wide.py): pack, run
// boundaries and decode, in the radix sort's 32-bit word form.
//
// Replaces no TPU kernel. The TPU package builds and reads these words
// with jnp under jax.jit (rayforce_tpu/engine/wide.py `pipeline`), where
// XLA fuses the elementwise i64 arithmetic; eager PyTorch ran it as ~90
// elementwise launches a query (a subtract, shift and or per key, the row
// iota and the trash where, psort's split64 and join64 around both sorts,
// the boundary compares, the decode's shift, mask and add per key), each
// moving the i64 words of every row through device memory.
//
// The layout is engine/wide.py `build_plan`'s, unchanged: key dim d takes
// `bits` bits at `shift` in i64 word `word`, (value - min) << shift; the
// row position takes the low pos_bits of word `pos_word`; bit 61 of word 0
// (the trash bit) marks a row the where clause drops. A word travels as
// psort's pair: the signed high i32 and the low i32 with its sign bit
// flipped, so that a signed compare of the pair gives the i64 order.
// n < 2^30, so the position lies in the low 30 bits of the low i32.
//
//   pack    the key columns (u8 / bool, i8, i16, i32 or i64, any stride, 0
//           for a broadcast scalar) and the where mask -> the 2 n_words
//           i32 sort words;
//   bound   the sorted words -> flags (a valid row whose key, the position
//           bits masked, differs from the row above), inc (flags + not
//           valid, the segment ids' increments), pos (the row position,
//           i64) and fkey (pos on a flagged row, else INT32_MAX);
//   decode  the words the order sort carried -> each key dim's column in
//           its output type, (word >> shift) & (2^bits - 1) + min.
//
// Every value is the plain version's (engine/wide.py `wide_keys_plain`,
// the i64 formulas followed by psort.split64), bit for bit: the i64 sums
// wrap, the casts truncate, as torch's do.
//
// Bound: memory. Each call reads every input once and writes every output
// once (bound reads each word of row i - 1 again, from the cache). One
// launch a call: a thread takes WK_ROWS rows WK_THREADS apart, so that a
// warp's loads of one column are coalesced and each thread has WK_ROWS
// loads in flight; a column's type is uniform, so the switch on it sits
// outside the row loop. The dims, words and outputs are kernel parameters
// (__grid_constant__, read from the constant bank): a plan of up to
// WK_MAX_DIMS key dims, and so WK_MAX_DIMS + 1 words, takes one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#define WK_THREADS 256
#define WK_ROWS 4
#define WK_MAX_DIMS 64
#define WK_MAX_WORDS (WK_MAX_DIMS + 1)
#define WK_TRASH_SHIFT 61

enum { KIND_U8 = 0, KIND_I8 = 1, KIND_I16 = 2, KIND_I32 = 3, KIND_I64 = 4 };

typedef unsigned long long u64;

// the kernels' names read wide_keys::... in a profile
namespace wide_keys {

struct Key {            // one key dim of pack, one output of decode
  void* p;              // pack: the column; decode: the output column
  int64_t stride;       // pack: elements a row (0: one value for all)
  int64_t min;          // the dim's least value
  int32_t kind;         // KIND_*
  int16_t word;         // its word (decode: among the carried words)
  int16_t shift;        // its shift in the word
  int32_t bits;         // its width (decode)
  int32_t pad;
};

struct PackParams {
  int64_t n;
  int n_dims, n_words, pos_word;
  const unsigned char* mask;   // null: no where clause
  int64_t mask_stride;
  Key key[WK_MAX_DIMS];        // in word order
  int32_t* hi[WK_MAX_WORDS];
  int32_t* lo[WK_MAX_WORDS];
};

struct BoundParams {
  int64_t n;
  int n_words, pos_word;
  uint32_t posmask;
  const int32_t* hi[WK_MAX_WORDS];
  const int32_t* lo[WK_MAX_WORDS];
  unsigned char* flags;
  int32_t* inc;
  int64_t* pos;
  int32_t* fkey;
};

struct DecodeParams {
  int64_t n;
  int n_dims;
  const int32_t* hi[WK_MAX_WORDS];
  const int32_t* lo[WK_MAX_WORDS];
  Key out[WK_MAX_DIMS];
};

__device__ __forceinline__ int64_t row(int r) {
  return (int64_t)blockIdx.x * (WK_THREADS * WK_ROWS) + threadIdx.x +
         (int64_t)r * WK_THREADS;
}

// acc[r] |= (column[i r] - min) << shift, the column read as T
template <typename T>
__device__ __forceinline__ void gather(const Key& k, int64_t n,
                                       u64 (&acc)[WK_ROWS]) {
  const T* p = (const T*)k.p;
  T v[WK_ROWS];
#pragma unroll
  for (int r = 0; r < WK_ROWS; ++r) {
    const int64_t i = row(r);
    v[r] = i < n ? p[i * k.stride] : T(0);
  }
#pragma unroll
  for (int r = 0; r < WK_ROWS; ++r)
    acc[r] |= ((u64)(int64_t)v[r] - (u64)k.min) << k.shift;
}

__device__ __forceinline__ void put_word(const PackParams& p, int w,
                                         u64 (&acc)[WK_ROWS]) {
#pragma unroll
  for (int r = 0; r < WK_ROWS; ++r) {
    const int64_t i = row(r);
    if (i >= p.n) continue;
    u64 v = acc[r];
    if (w == p.pos_word) v |= (u64)i;
    if (w == 0 && p.mask != nullptr && !p.mask[i * p.mask_stride])
      v |= 1ULL << WK_TRASH_SHIFT;
    p.hi[w][i] = (int32_t)(uint32_t)(v >> 32);
    p.lo[w][i] = (int32_t)((uint32_t)v ^ 0x80000000u);
    acc[r] = 0;
  }
}

__global__ void __launch_bounds__(WK_THREADS)
pack(const __grid_constant__ PackParams p) {
  u64 acc[WK_ROWS];
#pragma unroll
  for (int r = 0; r < WK_ROWS; ++r) acc[r] = 0;
  int w = 0;
  for (int d = 0; d < p.n_dims; ++d) {
    const Key& k = p.key[d];
    for (; w < k.word; ++w) put_word(p, w, acc);
    switch (k.kind) {
      case KIND_U8: gather<unsigned char>(k, p.n, acc); break;
      case KIND_I8: gather<signed char>(k, p.n, acc); break;
      case KIND_I16: gather<int16_t>(k, p.n, acc); break;
      case KIND_I32: gather<int32_t>(k, p.n, acc); break;
      default: gather<long long>(k, p.n, acc); break;
    }
  }
  for (; w < p.n_words; ++w) put_word(p, w, acc);
}

__global__ void __launch_bounds__(WK_THREADS)
bound(const __grid_constant__ BoundParams p) {
#pragma unroll
  for (int r = 0; r < WK_ROWS; ++r) {
    const int64_t i = row(r);
    if (i >= p.n) continue;
    // the i64 word 0 below 2^61 is its high i32 below 2^29
    const bool valid = p.hi[0][i] < (1 << (WK_TRASH_SHIFT - 32));
    bool diff = i == 0;
    for (int w = 0; w < p.n_words && !diff; ++w) {
      const uint32_t keep = w == p.pos_word ? ~p.posmask : ~0u;
      diff = p.hi[w][i] != p.hi[w][i - 1] ||
             (((uint32_t)p.lo[w][i] ^ (uint32_t)p.lo[w][i - 1]) & keep);
    }
    const bool f = valid && diff;
    const uint32_t at =
        ((uint32_t)p.lo[p.pos_word][i] ^ 0x80000000u) & p.posmask;
    p.flags[i] = f;
    p.inc[i] = (int32_t)f + (int32_t)!valid;
    p.pos[i] = (int64_t)at;
    p.fkey[i] = f ? (int32_t)at : 0x7FFFFFFF;
  }
}

// column[i r] = (word >> shift) & (2^bits - 1) + min, cast to T
template <typename T>
__device__ __forceinline__ void scatter(const DecodeParams& p, const Key& k) {
  const int32_t* hi = p.hi[k.word];
  const int32_t* lo = p.lo[k.word];
  const u64 mask = (1ULL << k.bits) - 1;
  int64_t v[WK_ROWS];
#pragma unroll
  for (int r = 0; r < WK_ROWS; ++r) {
    const int64_t i = row(r);
    v[r] = i < p.n ? (int64_t)(((u64)(uint32_t)hi[i] << 32) |
                               ((uint32_t)lo[i] ^ 0x80000000u))
                   : 0;
  }
  T* out = (T*)k.p;
#pragma unroll
  for (int r = 0; r < WK_ROWS; ++r) {
    const int64_t i = row(r);
    if (i < p.n)
      out[i] = (T)(int64_t)((((u64)(v[r] >> k.shift)) & mask) + (u64)k.min);
  }
}

__global__ void __launch_bounds__(WK_THREADS)
decode(const __grid_constant__ DecodeParams p) {
  for (int d = 0; d < p.n_dims; ++d) {
    const Key& k = p.out[d];
    switch (k.kind) {
      case KIND_U8: scatter<unsigned char>(p, k); break;
      case KIND_I8: scatter<signed char>(p, k); break;
      case KIND_I16: scatter<int16_t>(p, k); break;
      case KIND_I32: scatter<int32_t>(p, k); break;
      default: scatter<long long>(p, k); break;
    }
  }
}

static unsigned grid(int64_t n) {
  return (unsigned)((n + WK_THREADS * WK_ROWS - 1) / (WK_THREADS * WK_ROWS));
}

static bool kind_ok(int kind) { return kind >= KIND_U8 && kind <= KIND_I64; }

}  // namespace wide_keys

using namespace wide_keys;

// The sort words of n rows. Key dim d (in word order: words[d] never
// falls): keys[d] of kinds[d] (0 u8 or bool, 1 i8, 2 i16, 3 i32, 4 i64),
// row r at r * strides[d] elements, less mins[d], shifted by shifts[d]
// into word words[d]. The row position goes into word pos_word; mask
// (bytes, row r at r * mask_stride; null for none) sets the trash bit of
// word 0 where it is 0. hi[w], lo[w]: word w's (n,) i32 outputs. One
// launch; returns 0 or its cudaError; cudaErrorInvalidValue for arguments
// it does not take.
extern "C" int rf_wide_keys_pack(int64_t n, int n_dims,
                                 const void* const* keys,
                                 const int64_t* strides, const int* kinds,
                                 const int64_t* mins, const int* words,
                                 const int* shifts, int n_words, int pos_word,
                                 const void* mask, int64_t mask_stride,
                                 void* const* hi, void* const* lo,
                                 void* stream) {
  if (n < 0 || n >= (1LL << 30) || n_dims < 0 || n_dims > WK_MAX_DIMS ||
      n_words < 1 || n_words > WK_MAX_WORDS || pos_word < 0 ||
      pos_word >= n_words)
    return (int)cudaErrorInvalidValue;
  PackParams p = {};
  p.n = n;
  p.n_dims = n_dims;
  p.n_words = n_words;
  p.pos_word = pos_word;
  p.mask = (const unsigned char*)mask;
  p.mask_stride = mask_stride;
  for (int d = 0; d < n_dims; ++d) {
    if (!kind_ok(kinds[d]) || words[d] < (d ? words[d - 1] : 0) ||
        words[d] >= n_words || shifts[d] < 0 || shifts[d] > 63)
      return (int)cudaErrorInvalidValue;
    Key& k = p.key[d];
    k.p = (void*)keys[d];
    k.stride = strides[d];
    k.min = mins[d];
    k.kind = kinds[d];
    k.word = (int16_t)words[d];
    k.shift = (int16_t)shifts[d];
  }
  for (int w = 0; w < n_words; ++w) {
    p.hi[w] = (int32_t*)hi[w];
    p.lo[w] = (int32_t*)lo[w];
  }
  if (n == 0) return 0;
  pack<<<grid(n), WK_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The run boundaries of n sorted rows of n_words words (hi[w], lo[w]; the
// row position in the low pos_bits of word pos_word): flags (bytes, 0 or
// 1), inc (i32), pos (i64) and fkey (i32), each (n,). One launch; returns
// 0 or its cudaError; cudaErrorInvalidValue for arguments it does not take.
extern "C" int rf_wide_keys_bound(int64_t n, int n_words, int pos_word,
                                  int pos_bits, const void* const* hi,
                                  const void* const* lo, void* flags,
                                  void* inc, void* pos, void* fkey,
                                  void* stream) {
  if (n < 0 || n >= (1LL << 30) || n_words < 1 || n_words > WK_MAX_WORDS ||
      pos_word < 0 || pos_word >= n_words || pos_bits < 1 || pos_bits > 30)
    return (int)cudaErrorInvalidValue;
  BoundParams p = {};
  p.n = n;
  p.n_words = n_words;
  p.pos_word = pos_word;
  p.posmask = (1u << pos_bits) - 1;
  for (int w = 0; w < n_words; ++w) {
    p.hi[w] = (const int32_t*)hi[w];
    p.lo[w] = (const int32_t*)lo[w];
  }
  p.flags = (unsigned char*)flags;
  p.inc = (int32_t*)inc;
  p.pos = (int64_t*)pos;
  p.fkey = (int32_t*)fkey;
  if (n == 0) return 0;
  bound<<<grid(n), WK_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

// The key columns of n rows from n_words carried words (hi[w], lo[w]).
// Output d: outs[d], (n,) of kinds[d] (0 u8, 1 i8, 2 i16, 3 i32, 4 i64),
// from word words[d] at shifts[d], bits[d] wide, plus mins[d]. One launch;
// returns 0 or its cudaError; cudaErrorInvalidValue for arguments it does
// not take.
extern "C" int rf_wide_keys_decode(int64_t n, int n_words,
                                   const void* const* hi,
                                   const void* const* lo, int n_dims,
                                   const int* words, const int* shifts,
                                   const int* bits, const int64_t* mins,
                                   const int* kinds, void* const* outs,
                                   void* stream) {
  if (n < 0 || n >= (1LL << 30) || n_words < 1 || n_words > WK_MAX_WORDS ||
      n_dims < 0 || n_dims > WK_MAX_DIMS)
    return (int)cudaErrorInvalidValue;
  DecodeParams p = {};
  p.n = n;
  p.n_dims = n_dims;
  for (int w = 0; w < n_words; ++w) {
    p.hi[w] = (const int32_t*)hi[w];
    p.lo[w] = (const int32_t*)lo[w];
  }
  for (int d = 0; d < n_dims; ++d) {
    if (!kind_ok(kinds[d]) || words[d] < 0 || words[d] >= n_words ||
        bits[d] < 1 || shifts[d] < 0 || shifts[d] + bits[d] > 63)
      return (int)cudaErrorInvalidValue;
    Key& k = p.out[d];
    k.p = outs[d];
    k.min = mins[d];
    k.kind = kinds[d];
    k.word = (int16_t)words[d];
    k.shift = (int16_t)shifts[d];
    k.bits = bits[d];
  }
  if (n == 0 || n_dims == 0) return 0;
  decode<<<grid(n), WK_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
