// The sort-agg engine's main sort words (engine/sortagg.py): pack them
// before the sort, read them back after it.
//
// Replaces no TPU kernel. The TPU package builds and reads this key with
// jnp under jax.jit (rayforce_tpu/engine/sortagg.py `pipeline`), where XLA
// fuses the elementwise i64 arithmetic; eager PyTorch ran it as ~30-40
// launches a query over every row (the key codes' subtract and cast, the
// key's cast, shifts, row iota and ors, psort's split64 and join64 around
// the sort, the operand's quantising, the code's shift, the run starts,
// the compaction key's iota and where, each packed field's shift, mask
// and casts, the operand's read-back), each moving i64 rows through
// device memory.
//
// The layout is engine/sortagg.py `build_plan`'s, unchanged (its KeyPlan):
// the key is the mixed-radix group code (each key column less its least
// value, times the radices of the columns after it; a where-masked row
// takes n_codes), then, in the exact plan, the row position in pos_bits
// bits, then the packed columns, each (value - lo) << shift in vb bits.
// An i32 key is one sort word; an i64 key travels as psort's pair, the
// signed high i32 and the low i32 with its sign bit flipped, so that a
// signed compare of the pair gives the i64 order. The sort operands ride
// as psort._words of aggs.operand: an i32 word, an i64 or the bits of an
// f64 as a pair, or q32, an f64 on a decimal grid as
// (int32)rint(x * scale) with NaN as NULL_I32.
//
//   pack  the key columns (u8 / bool, i8, i16, i32 or i64), the packed
//         columns, the operand columns (any of those or f64) and the where
//         mask, each at its stride (0 for a broadcast scalar) -> the key
//         words, each operand's words, and the i32 codes where the plan
//         reads them (the head and tail sorts, med);
//   read  the sorted words -> sc (the group code, i32), the compaction
//         input (the flags of the run starts of valid rows, or the
//         compaction sort's key: the row where flagged, else row + 2^30),
//         the totals (flagged rows, valid rows; i32, by atomics: exact
//         and the same every run), and the lanes the segmented scans
//         read: a packed field as i32, or plus its lo as i64; several
//         fields at their offsets of one i64 sum lane; an operand's value
//         (aggs.from_operand: i64, or f64 with q32 as w * (1 / scale) and
//         NULL_I32 as NaN), its null mask (bool or i64) or its value with
//         nulls as a fill (aggs.skip_nulls).
//
// Every value is the plain version's (engine/sortagg.py
// `sortagg_keys_plain`, the torch formulas on the card), bit for bit: the
// i64 sums wrap, the casts truncate, an i32 key's arithmetic is the low 32
// bits of the same arithmetic in 64, a q32 word divides as torch divides
// a CUDA tensor by a host scalar (by its reciprocal), and an f64 operand's
// bits pass through untouched.
//
// Bound: memory. A call reads every input once and writes every output
// once (read takes the key words of row i - 1 again, from the cache). A
// thread takes SK_ROWS rows SK_THREADS apart, so that a warp's loads of
// one column are coalesced and each thread has SK_ROWS loads in flight;
// a column's type is uniform, so the switch on it sits outside the row
// loop. The columns, operands and lanes are kernel parameters
// (__grid_constant__, read from the constant bank); a plan with more
// operands than SK_PACK_OPS or lanes than SK_READ_LANES takes one more
// launch for each such share, the first launch of read alone writing sc,
// the compaction input and the totals.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define SK_THREADS 256
#define SK_ROWS 4
#define SK_MAX_KEYS 16
#define SK_MAX_FIELDS 32
#define SK_PACK_OPS 24
#define SK_READ_LANES 36
#define SK_MAX_PARTS SK_MAX_FIELDS
#define SK_NULL_I32 (-2147483647 - 1)
#define SK_BIG (1 << 30)

enum { KIND_U8 = 0, KIND_I8 = 1, KIND_I16 = 2, KIND_I32 = 3, KIND_I64 = 4,
       KIND_F64 = 5 };
enum { HOW_I32 = 0, HOW_I64 = 1, HOW_F64 = 2, HOW_Q32 = 3 };
enum { L_FIELD32 = 0, L_FIELD = 1, L_FUSED = 2, L_VALUE = 3, L_NULL = 4,
       L_NULLS = 5, L_FILL = 6 };

typedef unsigned long long u64;

// the kernels' names read sortagg_keys::... in a profile
namespace sortagg_keys {

struct Col {            // a key column (aux: its radix) or a packed column
  const void* p;        // (aux: its shift)
  int64_t stride;       // elements a row (0: one value for all)
  int64_t lo;           // its least value
  int32_t kind;         // KIND_*
  int32_t aux;
};

struct PackOp {         // one sort operand
  const void* p;
  int64_t stride;
  double scale;         // HOW_Q32
  int32_t* w0;          // its first word
  int32_t* w1;          // its second (HOW_I64, HOW_F64)
  int32_t kind, how;
};

struct PackParams {
  int64_t n;
  const unsigned char* mask;   // null: no where clause
  int64_t mask_stride;
  int32_t* key0;               // null: this launch writes operands alone
  int32_t* key1;               // null: an i32 key
  int32_t* codes;              // null: not read
  int32_t n_codes, pos_bits, vb, n_keys, n_fields, n_ops;
  Col key[SK_MAX_KEYS];
  Col field[SK_MAX_FIELDS];
  PackOp op[SK_PACK_OPS];
};

struct Lane {
  void* out;
  const int32_t* w0;    // an operand's words (w1 null: one word)
  const int32_t* w1;
  int64_t lo;           // L_FIELD: added; an integer operand: its null
  int64_t fill;         // L_FILL: a null's value (an f64's bits)
  double inv;           // HOW_Q32: 1 / scale
  int32_t op, how;      // L_*, HOW_*
  int32_t shift, bits;  // a field; L_FUSED: its first part, its parts
  int32_t has_null, pad;
};

struct Part {           // one field of a fused lane
  int16_t shift, bits, off, pad;
};

struct ReadParams {
  int64_t n;
  const int32_t* key0;
  const int32_t* key1;  // null: an i32 key
  int32_t* sc;          // null: a later launch, lanes alone
  void* comp;
  int32_t* tot;
  int32_t n_codes, shift_all, comp_flags, n_lanes;
  Part part[SK_MAX_PARTS];
  Lane lane[SK_READ_LANES];
};

__device__ __forceinline__ int64_t row(int r) {
  return (int64_t)blockIdx.x * (SK_THREADS * SK_ROWS) + threadIdx.x +
         (int64_t)r * SK_THREADS;
}

// v[r] = column[i r] as int64 (u8 / bool zero-extended, the rest signed)
template <typename T>
__device__ __forceinline__ void load(const void* p, int64_t stride, int64_t n,
                                     int64_t (&v)[SK_ROWS]) {
  const T* q = (const T*)p;
  T x[SK_ROWS];
#pragma unroll
  for (int r = 0; r < SK_ROWS; ++r) {
    const int64_t i = row(r);
    x[r] = i < n ? q[i * stride] : T(0);
  }
#pragma unroll
  for (int r = 0; r < SK_ROWS; ++r) v[r] = (int64_t)x[r];
}

__device__ __forceinline__ void load_int(int kind, const void* p,
                                         int64_t stride, int64_t n,
                                         int64_t (&v)[SK_ROWS]) {
  switch (kind) {
    case KIND_U8: load<unsigned char>(p, stride, n, v); break;
    case KIND_I8: load<signed char>(p, stride, n, v); break;
    case KIND_I16: load<int16_t>(p, stride, n, v); break;
    case KIND_I32: load<int32_t>(p, stride, n, v); break;
    default: load<long long>(p, stride, n, v); break;
  }
}

__device__ __forceinline__ void put_pair(int32_t* hi, int32_t* lo, int64_t i,
                                         u64 v) {
  hi[i] = (int32_t)(uint32_t)(v >> 32);
  lo[i] = (int32_t)((uint32_t)v ^ 0x80000000u);
}

__device__ __forceinline__ void pack_op(const PackOp& o, int64_t n) {
  int64_t v[SK_ROWS];
  if (o.how == HOW_F64 || o.how == HOW_Q32) {
    const double* q = (const double*)o.p;
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) {
      const int64_t i = row(r);
      v[r] = i < n ? __double_as_longlong(q[i * o.stride]) : 0;
    }
  } else {
    load_int(o.kind, o.p, o.stride, n, v);
  }
#pragma unroll
  for (int r = 0; r < SK_ROWS; ++r) {
    const int64_t i = row(r);
    if (i >= n) continue;
    switch (o.how) {
      case HOW_I32: o.w0[i] = (int32_t)v[r]; break;
      case HOW_Q32: {
        const double x = __longlong_as_double(v[r]);
        o.w0[i] = isnan(x) ? SK_NULL_I32 : (int32_t)rint(__dmul_rn(x, o.scale));
        break;
      }
      default: put_pair(o.w0, o.w1, i, (u64)v[r]); break;
    }
  }
}

__global__ void __launch_bounds__(SK_THREADS)
pack_words(const __grid_constant__ PackParams p) {
  if (p.key0 != nullptr) {
    uint32_t code[SK_ROWS];
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) code[r] = 0;
    for (int d = 0; d < p.n_keys; ++d) {
      const Col& k = p.key[d];
      int64_t v[SK_ROWS];
      load_int(k.kind, k.p, k.stride, p.n, v);
#pragma unroll
      for (int r = 0; r < SK_ROWS; ++r)
        code[r] = code[r] * (uint32_t)k.aux +
                  (uint32_t)((u64)v[r] - (u64)k.lo);
    }
    u64 key[SK_ROWS];
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) {
      const int64_t i = row(r);
      if (p.mask != nullptr && i < p.n && !p.mask[i * p.mask_stride])
        code[r] = (uint32_t)p.n_codes;
      if (p.codes != nullptr && i < p.n) p.codes[i] = (int32_t)code[r];
      key[r] = (u64)(int64_t)(int32_t)code[r];
      if (p.pos_bits) key[r] = (key[r] << p.pos_bits) | (u64)i;
      key[r] <<= p.vb;
    }
    for (int f = 0; f < p.n_fields; ++f) {
      const Col& c = p.field[f];
      int64_t v[SK_ROWS];
      load_int(c.kind, c.p, c.stride, p.n, v);
#pragma unroll
      for (int r = 0; r < SK_ROWS; ++r)
        key[r] |= ((u64)v[r] - (u64)c.lo) << c.aux;
    }
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) {
      const int64_t i = row(r);
      if (i >= p.n) continue;
      if (p.key1 != nullptr)
        put_pair(p.key0, p.key1, i, key[r]);
      else
        p.key0[i] = (int32_t)(uint32_t)key[r];
    }
  }
  for (int o = 0; o < p.n_ops; ++o) pack_op(p.op[o], p.n);
}

__device__ __forceinline__ int64_t key_at(const ReadParams& p, int64_t i) {
  if (p.key1 == nullptr) return (int64_t)p.key0[i];
  return (int64_t)(((u64)(uint32_t)p.key0[i] << 32) |
                   ((uint32_t)p.key1[i] ^ 0x80000000u));
}

__device__ __forceinline__ int64_t word_pair(const int32_t* w0,
                                             const int32_t* w1, int64_t i) {
  return (int64_t)(((u64)(uint32_t)w0[i] << 32) |
                   ((uint32_t)w1[i] ^ 0x80000000u));
}

// operand lane L at row i: its value (an f64's bits, or an integer) and
// whether it is null
__device__ __forceinline__ int64_t value(const Lane& L, int64_t i,
                                         bool& null) {
  switch (L.how) {
    case HOW_I32: {
      const int64_t v = (int64_t)L.w0[i];
      null = L.has_null && v == L.lo;
      return v;
    }
    case HOW_I64: {
      const int64_t v = word_pair(L.w0, L.w1, i);
      null = L.has_null && v == L.lo;
      return v;
    }
    case HOW_F64: {
      const int64_t v = word_pair(L.w0, L.w1, i);
      null = isnan(__longlong_as_double(v));
      return v;
    }
    default: {
      const int32_t w = L.w0[i];
      null = w == SK_NULL_I32;
      return null ? 0x7FF8000000000000LL
                  : __double_as_longlong(__dmul_rn((double)w, L.inv));
    }
  }
}

__global__ void __launch_bounds__(SK_THREADS)
read_words(const __grid_constant__ ReadParams p) {
  int64_t key[SK_ROWS];
#pragma unroll
  for (int r = 0; r < SK_ROWS; ++r) {
    const int64_t i = row(r);
    key[r] = i < p.n ? key_at(p, i) : 0;
  }
  if (p.sc != nullptr) {
    int flagged = 0, valid = 0;
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) {
      const int64_t i = row(r);
      if (i >= p.n) continue;
      const int32_t s = (int32_t)(key[r] >> p.shift_all);
      const bool ok = s < p.n_codes;
      const bool f =
          ok && (i == 0 || (int32_t)(key_at(p, i - 1) >> p.shift_all) != s);
      p.sc[i] = s;
      if (p.comp_flags)
        ((unsigned char*)p.comp)[i] = f;
      else
        ((int32_t*)p.comp)[i] = f ? (int32_t)i : (int32_t)i + SK_BIG;
      flagged += f;
      valid += ok;
    }
    __shared__ int sums[2][SK_THREADS / 32];
    flagged = __reduce_add_sync(0xffffffffu, (unsigned)flagged);
    valid = __reduce_add_sync(0xffffffffu, (unsigned)valid);
    if ((threadIdx.x & 31) == 0) {
      sums[0][threadIdx.x >> 5] = flagged;
      sums[1][threadIdx.x >> 5] = valid;
    }
    __syncthreads();
    if (threadIdx.x < 2) {
      int t = 0;
      for (int w = 0; w < SK_THREADS / 32; ++w) t += sums[threadIdx.x][w];
      if (t) atomicAdd(&p.tot[threadIdx.x], t);
    }
  }
  for (int l = 0; l < p.n_lanes; ++l) {
    const Lane& L = p.lane[l];
#pragma unroll
    for (int r = 0; r < SK_ROWS; ++r) {
      const int64_t i = row(r);
      if (i >= p.n) continue;
      switch (L.op) {
        case L_FIELD32:
          ((int32_t*)L.out)[i] =
              (int32_t)((key[r] >> L.shift) & ((1LL << L.bits) - 1));
          break;
        case L_FIELD:
          ((int64_t*)L.out)[i] = (int64_t)(
              (u64)((key[r] >> L.shift) & ((1LL << L.bits) - 1)) +
              (u64)L.lo);
          break;
        case L_FUSED: {
          u64 acc = 0;
          for (int q = L.shift; q < L.shift + L.bits; ++q) {
            const Part& P = p.part[q];
            acc |= (u64)((key[r] >> P.shift) & ((1LL << P.bits) - 1))
                   << P.off;
          }
          ((int64_t*)L.out)[i] = (int64_t)acc;
          break;
        }
        default: {
          bool null;
          const int64_t v = value(L, i, null);
          if (L.op == L_NULL)
            ((unsigned char*)L.out)[i] = null;
          else if (L.op == L_NULLS)
            ((int64_t*)L.out)[i] = null;
          else
            ((int64_t*)L.out)[i] = L.op == L_FILL && null ? L.fill : v;
        }
      }
    }
  }
}

static unsigned grid(int64_t n) {
  return (unsigned)((n + SK_THREADS * SK_ROWS - 1) / (SK_THREADS * SK_ROWS));
}

static bool int_kind(int kind) { return kind >= KIND_U8 && kind <= KIND_I64; }

}  // namespace sortagg_keys

using namespace sortagg_keys;

// The main sort's words of n rows. Key column d: keys[d] of key_kinds[d]
// (0 u8 or bool, 1 i8, 2 i16, 3 i32, 4 i64), row r at r * key_strides[d]
// elements, less key_los[d], in the radix key_rngs[d]; mask (bytes, row r
// at r * mask_stride; null for none) gives a row where it is 0 the code
// n_codes. Packed column f: fields[f] (a key kind), less field_los[f],
// shifted by field_shifts[f] under the code (and the row position in
// pos_bits bits) shifted by vb. key0, key1: the key's words (key1 null:
// an i32 key); codes: the (n,) i32 codes or null. Operand o: ops[o] of
// op_kinds[o] (a key kind or 5 f64), written as op_hows[o] (0 i32, 1 i64,
// 2 f64, 3 q32 at op_scales[o]) into op_w0[o] and, for i64 and f64,
// op_w1[o]. *launches receives the launches made: one, and one more for
// each SK_PACK_OPS operands after the first SK_PACK_OPS. Returns 0 or
// the first cudaError; cudaErrorInvalidValue for arguments it does not
// take, before any launch.
extern "C" int rf_sortagg_keys_pack(
    int64_t n, int n_codes, int pos_bits, int vb, int n_keys,
    const void* const* keys, const int64_t* key_strides,
    const int* key_kinds, const int64_t* key_los, const int64_t* key_rngs,
    int n_fields, const void* const* fields, const int64_t* field_strides,
    const int* field_kinds, const int64_t* field_los,
    const int* field_shifts, int n_ops, const void* const* ops,
    const int64_t* op_strides, const int* op_kinds, const int* op_hows,
    const double* op_scales, void* const* op_w0, void* const* op_w1,
    const void* mask, int64_t mask_stride, void* key0, void* key1,
    void* codes, int* launches, void* stream) {
  *launches = 0;
  if (n < 0 || n >= (1LL << 30) || n_keys < 0 || n_keys > SK_MAX_KEYS ||
      n_fields < 0 || n_fields > SK_MAX_FIELDS || n_ops < 0 ||
      pos_bits < 0 || pos_bits > 30 || vb < 0 || vb > 62 ||
      key0 == nullptr)
    return (int)cudaErrorInvalidValue;
  PackParams p = {};
  p.n = n;
  p.mask = (const unsigned char*)mask;
  p.mask_stride = mask_stride;
  p.key0 = (int32_t*)key0;
  p.key1 = (int32_t*)key1;
  p.codes = (int32_t*)codes;
  p.n_codes = n_codes;
  p.pos_bits = pos_bits;
  p.vb = vb;
  p.n_keys = n_keys;
  p.n_fields = n_fields;
  for (int d = 0; d < n_keys; ++d) {
    if (!int_kind(key_kinds[d])) return (int)cudaErrorInvalidValue;
    p.key[d] = {keys[d], key_strides[d], key_los[d], key_kinds[d],
                (int32_t)(uint32_t)(u64)key_rngs[d]};
  }
  for (int f = 0; f < n_fields; ++f) {
    if (!int_kind(field_kinds[f]) || field_shifts[f] < 0 ||
        field_shifts[f] > 63)
      return (int)cudaErrorInvalidValue;
    p.field[f] = {fields[f], field_strides[f], field_los[f], field_kinds[f],
                  field_shifts[f]};
  }
  for (int o = 0; o < n_ops; ++o) {
    const bool f64 = op_hows[o] == HOW_F64 || op_hows[o] == HOW_Q32;
    if (op_hows[o] < HOW_I32 || op_hows[o] > HOW_Q32 ||
        (f64 ? op_kinds[o] != KIND_F64 : !int_kind(op_kinds[o])) ||
        ((op_hows[o] == HOW_I64 || op_hows[o] == HOW_F64) &&
         op_w1[o] == nullptr))
      return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  int o = 0;
  do {
    p.n_ops = n_ops - o < SK_PACK_OPS ? n_ops - o : SK_PACK_OPS;
    for (int j = 0; j < p.n_ops; ++j, ++o)
      p.op[j] = {ops[o], op_strides[o], op_scales[o], (int32_t*)op_w0[o],
                 (int32_t*)op_w1[o], op_kinds[o], op_hows[o]};
    pack_words<<<grid(n), SK_THREADS, 0, (cudaStream_t)stream>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
    p.key0 = p.key1 = p.codes = nullptr;   // later launches: operands
  } while (o < n_ops);
  return 0;
}

// The sorted words of n rows read back. key0, key1: the key's words (key1
// null: an i32 key). sc: (n,) i32, the key >> shift_all; comp: (n,) bytes,
// 1 at a valid row (sc < n_codes) whose sc differs from the row above's,
// where comp_flags, else i32, that row's index there and index + 2^30
// elsewhere; tot: 2 i32, those rows' count and the valid rows'. Lane l
// (lane_ops[l], 0-6: field32, field, fused, value, null, nulls, fill)
// into lane_outs[l]: a field at lane_shifts[l], lane_bits[l] wide (plus
// lane_los[l]); fused, parts lane_shifts[l] .. + lane_bits[l] of
// part_shifts, part_bits, part_offs; an operand's words lane_w0[l],
// lane_w1[l] as lane_hows[l], an integer's null lane_los[l] where
// lane_has_null[l], a q32's 1 / scale lane_invs[l], a null's fill
// lane_fills[l]. *launches receives the launches made: one, and one more
// for each SK_READ_LANES lanes after the first SK_READ_LANES. Returns 0
// or the first cudaError; cudaErrorInvalidValue for arguments it does not
// take, before any launch.
extern "C" int rf_sortagg_keys_read(
    int64_t n, int n_codes, int shift_all, const void* key0,
    const void* key1, void* sc, void* comp, int comp_flags, void* tot,
    int n_lanes, const int* lane_ops, void* const* lane_outs,
    const void* const* lane_w0, const void* const* lane_w1,
    const int* lane_hows, const int* lane_shifts, const int* lane_bits,
    const int64_t* lane_los, const int64_t* lane_fills,
    const double* lane_invs, const int* lane_has_null, int n_parts,
    const int* part_shifts, const int* part_bits, const int* part_offs,
    int* launches, void* stream) {
  *launches = 0;
  if (n < 0 || n >= (1LL << 30) || shift_all < 0 || shift_all > 63 ||
      n_lanes < 0 || n_parts < 0 || n_parts > SK_MAX_PARTS ||
      key0 == nullptr || sc == nullptr || comp == nullptr || tot == nullptr)
    return (int)cudaErrorInvalidValue;
  ReadParams p = {};
  p.n = n;
  p.key0 = (const int32_t*)key0;
  p.key1 = (const int32_t*)key1;
  p.sc = (int32_t*)sc;
  p.comp = comp;
  p.tot = (int32_t*)tot;
  p.n_codes = n_codes;
  p.shift_all = shift_all;
  p.comp_flags = comp_flags;
  for (int q = 0; q < n_parts; ++q) {
    if (part_shifts[q] < 0 || part_bits[q] < 1 ||
        part_shifts[q] + part_bits[q] > 63 || part_offs[q] < 0 ||
        part_offs[q] > 63)
      return (int)cudaErrorInvalidValue;
    p.part[q] = {(int16_t)part_shifts[q], (int16_t)part_bits[q],
                 (int16_t)part_offs[q], 0};
  }
  for (int l = 0; l < n_lanes; ++l) {
    const int op = lane_ops[l], how = lane_hows[l];
    const bool field = op == L_FIELD32 || op == L_FIELD;
    if (op < L_FIELD32 || op > L_FILL || lane_outs[l] == nullptr ||
        (field && (lane_shifts[l] < 0 || lane_bits[l] < 1 ||
                   lane_shifts[l] + lane_bits[l] > 63)) ||
        (op == L_FUSED && (lane_shifts[l] < 0 || lane_bits[l] < 1 ||
                           lane_shifts[l] + lane_bits[l] > n_parts)) ||
        (op >= L_VALUE &&
         (how < HOW_I32 || how > HOW_Q32 || lane_w0[l] == nullptr ||
          ((how == HOW_I64 || how == HOW_F64) && lane_w1[l] == nullptr))))
      return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaMemsetAsync(tot, 0, 2 * sizeof(int32_t),
                                  (cudaStream_t)stream);
  if (e != cudaSuccess || n == 0) return (int)e;
  int l = 0;
  do {
    p.n_lanes = n_lanes - l < SK_READ_LANES ? n_lanes - l : SK_READ_LANES;
    for (int j = 0; j < p.n_lanes; ++j, ++l)
      p.lane[j] = {lane_outs[l], (const int32_t*)lane_w0[l],
                   (const int32_t*)lane_w1[l], lane_los[l], lane_fills[l],
                   lane_invs[l], lane_ops[l], lane_hows[l], lane_shifts[l],
                   lane_bits[l], lane_has_null[l], 0};
    read_words<<<grid(n), SK_THREADS, 0, (cudaStream_t)stream>>>(p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ++*launches;
    p.sc = nullptr;   // later launches: lanes alone
  } while (l < n_lanes);
  return 0;
}
