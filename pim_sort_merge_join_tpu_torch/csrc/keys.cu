// The fused 1:1 join's key vector for the PyTorch port: for two tables of
// any of the six table types (columnar/dtypes) and their promoted type P,
//   keys[o] for o in [0, cap1 + cap2), table 1's rows first, where row i of a
//   table gives the order key in P of its key column's value converted to P
//   if i < num_rows (read here from the table's row count) and the table's
//   predicate holds on the row's predicate column, and the order key in P of
//   the table's own sentinel (its type's maximum, +inf for floats) converted
//   to P otherwise: for a table of type P that is P's order sentinel;
// narrowed (P int64 or uint64), keys[o] is int32: the sentinel and a key
// equal to it INT32_MAX, any other key its low 32 bits (a uint64 key's own
// bits); for a 4-byte P, keys[o] is P's int32 order key; else int64. That is
// what ops/kernels/keys.join_keys_plain makes with torch ops (the predicate
// masks, Table.order_keys, columnar/dtypes.narrow32, one cat).
//
// Replaces no Pallas kernel. The JAX package makes these keys in one jitted
// function (pim_sort_merge_join_tpu/engine/pipeline.py, pipeline_core; ops/
// join.py, filter_join_one_to_one), which XLA fuses into one pass. Its port
// as torch ops launched about sixteen elementwise kernels and a cat, and
// copied the predicate's value from the host on every query: a row of four
// int64 is one 32-byte sector, so each strided column op read the sectors
// of a whole table.
//
// The types, as columnar/dtypes defines them: a table's kind (signed,
// unsigned or float) and width travel with it; the predicate compares in the
// table's own type (integers through their order keys, which keep their
// order; floats as floats, so a NaN fails every operator but !=); the value
// is converted to P as torch's .to converts it (integers widened, integers
// to floats rounded to nearest, float32 to float64 exactly); the order key
// is columnar/dtypes.order_key (unsigned: the sign bit flipped; floats: the
// total-order map, -0.0 as +0.0, +inf and NaN P's signed maximum). Every
// type test is on arguments, the same for every thread.
//
// What bounds it on an H100: bytes. Each row's key and predicate columns are
// read once and each key written once; where a row fits one sector (two 10M
// x 4 int64 tables), that reads both tables whole: 640 MB, and 80 MB of
// int32 keys written, 0.215 ms at 3.35 TB/s. The design keeps to that:
//   - one grid, one wave of the card's resident blocks, walks the output in
//     spans of 32 * KEYS_ROWS keys in a grid-stride loop, a warp a span:
//     lane l takes keys l, l + 32, ..., so each load reads 32 neighbouring
//     rows and each store writes 32 neighbouring keys; a span inside one
//     table issues its KEYS_ROWS loads together;
//   - where a table is contiguous from a 16-byte aligned base, each row's
//     key comes from one 16-byte load (__ldg) of the chunk that holds it,
//     and its predicate column from the same load where the chunk holds
//     both; an element's chunk is its flat index / (16 / its width), so any
//     row width takes this path. A view that is strided or misaligned, and
//     the last rows, whose chunk would run past the buffer's end, are read
//     element by element from their strides;
//   - the predicate arrives as arguments: its column, the value it compares
//     with, and the operator as the outcomes it keeps (bit 0 below the
//     value, bit 1 equal, bit 2 above, bit 3 unordered: a NaN), so nothing
//     is copied from the host and the test takes no branch on it.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

#define KEYS_THREADS 256
#define KEYS_ROWS 4  // keys a lane takes a span
#define KEYS_MAX_DEVICES 64

namespace {

// A type's kind (columnar/dtypes); its width is 1 << shift bytes (2 or 3).
enum Kind { SIGNED = 0, UNSIGNED = 1, FLOAT = 2 };

struct KeyTable {
  const char* base;
  int64_t rows, s0, s1;  // capacity; strides in elements
  int64_t vec_rows;      // rows [0, vec_rows) read 16 bytes a load
  const int* num_rows;
  int64_t value;     // the predicate's: an integer's order key, a float's double bits
  int64_t sentinel;  // the bits of the type's key sentinel
  int ncol, key, pcol, holds;
  int kind, shift;
};

// The keys' type: P's kind and width, and whether they are narrowed.
struct KeyType {
  int kind, shift, narrow;
};

// The element at `e` elements from `base`, its bits zero-extended.
__device__ __forceinline__ uint64_t ld(const KeyTable& t, int64_t e) {
  if (t.shift == 3) return (uint64_t)__ldg(reinterpret_cast<const long long*>(t.base) + e);
  return (uint64_t)__ldg(reinterpret_cast<const unsigned int*>(t.base) + e);
}

// Element e of the buffer from the 16-byte chunk v that holds it.
__device__ __forceinline__ uint64_t in_chunk(const uint4& v, int64_t e, int shift) {
  if (shift == 3) return (e & 1) ? ((uint64_t)v.w << 32 | v.z) : ((uint64_t)v.y << 32 | v.x);
  const int p = (int)(e & 3);
  return p == 0 ? v.x : (p == 1 ? v.y : (p == 2 ? v.z : v.w));
}

__device__ __forceinline__ int64_t as_signed(uint64_t b, int shift) {
  return shift == 3 ? (int64_t)b : (int64_t)(int32_t)(uint32_t)b;
}

__device__ __forceinline__ uint64_t as_unsigned(uint64_t b, int shift) {
  return shift == 3 ? b : (uint64_t)(uint32_t)b;
}

__device__ __forceinline__ double as_double(uint64_t b, int shift) {
  return shift == 3 ? __longlong_as_double((long long)b) : (double)__int_as_float((int)(uint32_t)b);
}

// An integer's order key, sign-extended to 64 bits.
__device__ __forceinline__ int64_t int_order(uint64_t b, int kind, int shift) {
  if (kind == SIGNED) return as_signed(b, shift);
  return shift == 3 ? (int64_t)(b ^ 0x8000000000000000ull)
                    : (int64_t)(int32_t)((uint32_t)b ^ 0x80000000u);
}

// columnar/dtypes.order_key, sign-extended to 64 bits.
__device__ __forceinline__ int64_t order_key(uint64_t b, int kind, int shift) {
  if (kind != FLOAT) return int_order(b, kind, shift);
  if (shift == 3) {
    const int64_t s = (int64_t)b;
    const double x = __longlong_as_double(s);
    return !(x < INFINITY) ? INT64_MAX : (x == 0.0 ? 0 : (s < 0 ? s ^ INT64_MAX : s));
  }
  const int32_t s = (int32_t)(uint32_t)b;
  const float x = __int_as_float(s);
  return !(x < INFINITY) ? INT32_MAX : (x == 0.0f ? 0 : (s < 0 ? s ^ INT32_MAX : s));
}

// Which outcome the predicate's column `p` gives against its value.
__device__ __forceinline__ int outcome(const KeyTable& t, uint64_t p) {
  if (t.kind == FLOAT) {
    const double x = as_double(p, t.shift), v = __longlong_as_double((long long)t.value);
    return x < v ? 0 : (x == v ? 1 : (x > v ? 2 : 3));
  }
  const int64_t x = int_order(p, t.kind, t.shift);
  return x < t.value ? 0 : (x == t.value ? 1 : 2);
}

// The bits of `b`, a value of the table's type, converted to the keys' type
// as torch's .to converts it; the promotions of columnar/dtypes.promote only.
__device__ __forceinline__ uint64_t convert(uint64_t b, int kind, int shift, const KeyType& to) {
  if (kind == to.kind && shift == to.shift) return b;
  if (to.kind == FLOAT && to.shift == 3) {
    const double d = kind == FLOAT ? as_double(b, shift)
                     : (kind == UNSIGNED ? (double)as_unsigned(b, shift) : (double)as_signed(b, shift));
    return (uint64_t)__double_as_longlong(d);
  }
  if (to.kind == FLOAT) {  // float32 from an integer, rounded once
    const float f = kind == UNSIGNED ? (float)as_unsigned(b, shift) : (float)as_signed(b, shift);
    return (uint64_t)(uint32_t)__float_as_int(f);
  }
  return kind == SIGNED ? (uint64_t)as_signed(b, shift) : as_unsigned(b, shift);
}

// Row r's order key in the keys' type, sign-extended to 64 bits.
__device__ __forceinline__ int64_t row_key(const KeyTable& t, const KeyType& to, int64_t valid_rows,
                                           int64_t r) {
  uint64_t key, pred;
  if (r < t.vec_rows) {
    const uint4* c = reinterpret_cast<const uint4*>(t.base);
    const int per = 4 - t.shift;  // log2 of the elements in a chunk
    const int64_t ek = r * t.ncol + t.key, ep = r * t.ncol + t.pcol;
    const uint4 kv = __ldg(c + (ek >> per));
    key = in_chunk(kv, ek, t.shift);
    pred = (ep >> per) == (ek >> per) ? in_chunk(kv, ep, t.shift) : in_chunk(__ldg(c + (ep >> per)), ep, t.shift);
  } else {
    key = ld(t, r * t.s0 + t.key * t.s1);
    pred = ld(t, r * t.s0 + t.pcol * t.s1);
  }
  const bool keep = r < valid_rows && ((t.holds >> outcome(t, pred)) & 1);
  return order_key(convert(keep ? key : (uint64_t)t.sentinel, t.kind, t.shift, to), to.kind, to.shift);
}

template <typename K>
struct Out;

template <>
struct Out<int64_t> {
  static __device__ __forceinline__ int64_t of(int64_t k, const KeyType&) { return k; }
};

template <>
struct Out<int32_t> {
  // A 4-byte type's key as it is; narrowed, the order key's own bits (a
  // uint64 key's flip undone) cut to their low 32 bits.
  static __device__ __forceinline__ int32_t of(int64_t k, const KeyType& to) {
    if (!to.narrow) return (int32_t)k;
    const uint64_t flip = to.kind == UNSIGNED ? 0x8000000000000000ull : 0;
    return k == INT64_MAX ? INT32_MAX : (int32_t)(uint32_t)((uint64_t)k ^ flip);
  }
};

template <typename K>
__device__ __forceinline__ K key_at(const KeyTable& t1, const KeyTable& t2, const KeyType& to,
                                    int64_t valid1, int64_t valid2, int64_t j) {
  return Out<K>::of(j < t1.rows ? row_key(t1, to, valid1, j) : row_key(t2, to, valid2, j - t1.rows), to);
}

template <typename K>
__global__ void __launch_bounds__(KEYS_THREADS)
join_keys_kernel(KeyTable t1, KeyTable t2, KeyType to, K* __restrict__ out) {
  constexpr int64_t SPAN = 32 * KEYS_ROWS;
  const int64_t cap1 = t1.rows, n = t1.rows + t2.rows;
  const int64_t spans = (n + SPAN - 1) / SPAN;
  const int64_t valid1 = *t1.num_rows, valid2 = *t2.num_rows;
  const int64_t nwarps = (int64_t)gridDim.x * (KEYS_THREADS / 32);
  const int lane = threadIdx.x & 31;
  for (int64_t w = ((int64_t)blockIdx.x * KEYS_THREADS + threadIdx.x) >> 5; w < spans; w += nwarps) {
    const int64_t first = w * SPAN, o = first + lane;
    K k[KEYS_ROWS];
    if (first + SPAN <= cap1) {
#pragma unroll
      for (int u = 0; u < KEYS_ROWS; ++u) k[u] = Out<K>::of(row_key(t1, to, valid1, o + 32 * u), to);
    } else if (first >= cap1 && first + SPAN <= n) {
#pragma unroll
      for (int u = 0; u < KEYS_ROWS; ++u) k[u] = Out<K>::of(row_key(t2, to, valid2, o + 32 * u - cap1), to);
    } else {  // the span across the tables' boundary, or the last
#pragma unroll
      for (int u = 0; u < KEYS_ROWS; ++u) {
        const int64_t j = o + 32 * u;
        if (j < n) k[u] = key_at<K>(t1, t2, to, valid1, valid2, j);
      }
    }
#pragma unroll
    for (int u = 0; u < KEYS_ROWS; ++u) {
      if (o + 32 * u < n) out[o + 32 * u] = k[u];
    }
  }
}

// Blocks of one wave on the current device, found once per device.
template <typename K>
int wave_blocks() {
  static int blocks[KEYS_MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= KEYS_MAX_DEVICES) return 1;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, join_keys_kernel<K>, KEYS_THREADS, 0);
    const int wave = sms * per_sm;
    blocks[dev] = wave < 1 ? 1 : wave;
  }
  return blocks[dev];
}

bool valid_type(int kind, int shift) {
  return kind >= SIGNED && kind <= FLOAT && (shift == 2 || shift == 3);
}

bool make_table(const void* base, int64_t rows, int ncol, int64_t s0, int64_t s1, const void* num_rows,
                int kind, int shift, int contiguous, int key, int pcol, int holds, int64_t value,
                int64_t sentinel, KeyTable* t) {
  if (rows < 0 || num_rows == nullptr || holds < 0 || holds > 15 || !valid_type(kind, shift)) return false;
  if (rows > 0 && (base == nullptr || ncol < 1 || key < 0 || key >= ncol || pcol < 0 ||
                   pcol >= ncol || s0 < 0 || s1 < 0)) {
    return false;
  }
  // Read 16 bytes a load, a row's chunk must end inside the buffer: the rows
  // whose elements all lie in whole chunks.
  const bool chunks = contiguous && reinterpret_cast<uintptr_t>(base) % 16 == 0;
  const int64_t whole = rows > 0 ? ((rows * ncol) >> (4 - shift)) << (4 - shift) : 0;
  const int64_t vec_rows = chunks && rows > 0 ? whole / ncol : 0;
  *t = KeyTable{static_cast<const char*>(base), rows, s0, s1, vec_rows,
                static_cast<const int*>(num_rows), value, sentinel, ncol, key, pcol, holds, kind, shift};
  return true;
}

template <typename K>
int launch(const KeyTable& t1, const KeyTable& t2, const KeyType& to, void* out, cudaStream_t stream) {
  const int64_t lanes = (t1.rows + t2.rows + KEYS_ROWS - 1) / KEYS_ROWS;
  int64_t blocks = (lanes + KEYS_THREADS - 1) / KEYS_THREADS;
  const int wave = wave_blocks<K>();
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  join_keys_kernel<K><<<(unsigned)blocks, KEYS_THREADS, 0, stream>>>(t1, t2, to, static_cast<K*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

// Per table: d, a [rows, ncol] view of kind `kind` (0 signed, 1 unsigned, 2
// float) and 1 << shift bytes an element, s0 and s1 its strides in elements,
// `contiguous` when its rows follow each other with no gap; num_rows, the
// table's int32 row count on the card; key and pcol, its key and predicate
// columns in [0, ncol); holds and value, the predicate's operator (bit 0
// below, bit 1 equal, bit 2 above, bit 3 unordered) and value (an integer
// type's order key, sign-extended; a float type's value as a double's bits);
// sentinel, the bits of the type's key sentinel. to_kind and to_shift: the
// keys' type P; narrow: an 8-byte integer P's keys narrowed. out: int32
// (narrow, or a 4-byte P) or int64 [rows1 + rows2].
extern "C" int smj_join_keys(const void* d1, int64_t rows1, int ncol1, int64_t s01, int64_t s11,
                             const void* num_rows1, int kind1, int shift1, int contiguous1, int key1,
                             int pcol1, int holds1, int64_t value1, int64_t sentinel1,
                             const void* d2, int64_t rows2, int ncol2, int64_t s02, int64_t s12,
                             const void* num_rows2, int kind2, int shift2, int contiguous2, int key2,
                             int pcol2, int holds2, int64_t value2, int64_t sentinel2,
                             int to_kind, int to_shift, int narrow, void* out, void* stream) {
  KeyTable t1, t2;
  if (!make_table(d1, rows1, ncol1, s01, s11, num_rows1, kind1, shift1, contiguous1, key1, pcol1, holds1,
                  value1, sentinel1, &t1) ||
      !make_table(d2, rows2, ncol2, s02, s12, num_rows2, kind2, shift2, contiguous2, key2, pcol2, holds2,
                  value2, sentinel2, &t2) ||
      !valid_type(to_kind, to_shift) || (narrow && (to_kind == FLOAT || to_shift != 3)) || out == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows1 + rows2 == 0) return (int)cudaSuccess;
  const KeyType to{to_kind, to_shift, narrow ? 1 : 0};
  return to.narrow || to.shift == 2 ? launch<int32_t>(t1, t2, to, out, (cudaStream_t)stream)
                                    : launch<int64_t>(t1, t2, to, out, (cudaStream_t)stream);
}
