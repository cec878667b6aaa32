// The narrow probe's extremes for the PyTorch port: over the raw buffers of
// two tables, padding included,
//   out[0] = min(key column k1 of d1, key column k2 of d2),  out[1] = min of every value,
//   out[2] = max of the same key columns,                    out[3] = max of every value,
// all as order keys (int64 as it is, uint64 with its sign bit flipped), so
// that engine/pipeline.resolve_narrow decides narrow_keys / narrow_data
// from one 32-byte readback.
//
// Replaces no Pallas kernel. The JAX package's probe (pim_sort_merge_join_tpu/
// engine/pipeline.py, QueryPipeline._resolve_narrow_device, `probe`) is one
// jitted function, which XLA fuses into one pass. Its port as torch ops
// (ops/kernels/probe.narrow_extremes_plain) launched eight reductions: a row
// of four int64 is one 32-byte sector, so each strided column reduction read
// as many sectors as a whole-table reduction.
//
// What bounds it on an H100: bytes, each table's buffer read once (two 10M x
// 4 int64 tables: 640 MB, 0.191 ms at 3.35 TB/s). The design keeps to that:
//   - one grid, one wave of the card's resident blocks, walks both buffers
//     in a grid-stride loop; where a buffer is contiguous and 16-byte
//     aligned each thread keeps PROBE_UNROLL 16-byte streaming loads
//     (__ldcs: read once, first out of the cache) in flight. An
//     element's column is its flat index modulo ncol, carried from one load
//     to the next by adding a constant (no division in the loop), so a row
//     may straddle two loads and any row width takes the vector path;
//   - an odd element count leaves one element to a scalar tail; a view that
//     is strided or not 16-byte aligned is read row by row from its strides;
//   - the four extremes stay in registers, then warp shuffles and shared
//     memory reduce a block; each block publishes its four values and the
//     last block to take a ticket folds them and writes `out`. The ticket is
//     the first word of `scratch`, which the caller zeroes once and the last
//     block sets back to 0, so one launch does the whole probe.
// Min and max are exact in any order. On an H100 80GB HBM3 at 700 W, over
// two 10M x 4 int64 tables, 512 threads a block with 8 loads each and
// __ldcs took 0.219 ms, the 17 other pairings of 256 or 512 threads, 2, 4
// or 8 loads and __ldg, __ldcs or __ldlu 0.219-0.241 ms (CUDA events,
// median of 21); two torch.aminmax, one a table, 0.237 ms.

#include <cstdint>
#include <cuda_runtime.h>

#define PROBE_THREADS 512
#define PROBE_UNROLL 8
// The most blocks a launch takes: `scratch` holds a record for each.
#define PROBE_MAX_BLOCKS 1024
#define PROBE_MAX_DEVICES 64

namespace {

struct ProbeBuf {
  const int64_t* base;
  int64_t rows, s0, s1;  // strides in elements
  int ncol, key;
  int64_t flip;  // XORed into each value: its order key
  int vec;       // rows * ncol contiguous elements from a 16-byte aligned base
};

struct Extremes {
  int64_t kmin, kmax, amin, amax;
};

__device__ __forceinline__ Extremes none() { return {INT64_MAX, INT64_MIN, INT64_MAX, INT64_MIN}; }

__device__ __forceinline__ int64_t lo64(int64_t a, int64_t b) { return b < a ? b : a; }
__device__ __forceinline__ int64_t hi64(int64_t a, int64_t b) { return b > a ? b : a; }

__device__ __forceinline__ int64_t ld(const int64_t* p) {
  return (int64_t)__ldg(reinterpret_cast<const long long*>(p));
}

__device__ __forceinline__ void take(Extremes& x, int64_t v, bool is_key) {
  x.amin = lo64(x.amin, v);
  x.amax = hi64(x.amax, v);
  if (is_key) {
    x.kmin = lo64(x.kmin, v);
    x.kmax = hi64(x.kmax, v);
  }
}

__device__ __forceinline__ void combine(Extremes& x, const Extremes& y) {
  x.kmin = lo64(x.kmin, y.kmin);
  x.kmax = hi64(x.kmax, y.kmax);
  x.amin = lo64(x.amin, y.amin);
  x.amax = hi64(x.amax, y.amax);
}

__device__ __forceinline__ Extremes warp_reduce(Extremes x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Extremes y;
    y.kmin = __shfl_down_sync(0xffffffffu, (long long)x.kmin, off);
    y.kmax = __shfl_down_sync(0xffffffffu, (long long)x.kmax, off);
    y.amin = __shfl_down_sync(0xffffffffu, (long long)x.amin, off);
    y.amax = __shfl_down_sync(0xffffffffu, (long long)x.amax, off);
    combine(x, y);
  }
  return x;
}

// The block's extremes, in thread 0.
__device__ __forceinline__ Extremes block_reduce(Extremes x) {
  __shared__ Extremes part[PROBE_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_reduce(x);
  if (lane == 0) part[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < PROBE_THREADS / 32 ? part[lane] : none();
    x = warp_reduce(x);
  }
  __syncthreads();  // `part` is free again
  return x;
}

// A contiguous buffer, two elements a load. Element e lies in column e %
// ncol; `c` is the column of the thread's next pair's first element, and
// the second element is a key iff c == kprev, the column before the key.
__device__ __forceinline__ void scan_vec(const ProbeBuf& b, Extremes& x, int64_t t, int64_t nthreads) {
  const int64_t n = b.rows * b.ncol;
  const int64_t npairs = n >> 1;
  const longlong2* p = reinterpret_cast<const longlong2*>(b.base);
  const int ncol = b.ncol, key = b.key, kprev = b.key == 0 ? b.ncol - 1 : b.key - 1;
  const int adv = (int)((2 * nthreads) % ncol);
  const int64_t flip = b.flip;
  int c = (int)((2 * t) % ncol);
  int64_t i = t;
  for (; i + (PROBE_UNROLL - 1) * nthreads < npairs; i += PROBE_UNROLL * nthreads) {
    longlong2 v[PROBE_UNROLL];
#pragma unroll
    for (int u = 0; u < PROBE_UNROLL; ++u) v[u] = __ldcs(p + i + u * nthreads);
#pragma unroll
    for (int u = 0; u < PROBE_UNROLL; ++u) {
      take(x, v[u].x ^ flip, c == key);
      take(x, v[u].y ^ flip, c == kprev);
      c += adv;
      if (c >= ncol) c -= ncol;
    }
  }
  for (; i < npairs; i += nthreads) {
    const longlong2 v = __ldg(p + i);
    take(x, v.x ^ flip, c == key);
    take(x, v.y ^ flip, c == kprev);
    c += adv;
    if (c >= ncol) c -= ncol;
  }
  if ((n & 1) && t == 0) take(x, ld(b.base + n - 1) ^ flip, (n - 1) % ncol == key);
}

// Any other layout: one row a thread, its elements by the strides.
__device__ __forceinline__ void scan_rows(const ProbeBuf& b, Extremes& x, int64_t t, int64_t nthreads) {
  for (int64_t r = t; r < b.rows; r += nthreads) {
    const int64_t* row = b.base + r * b.s0;
    for (int c = 0; c < b.ncol; ++c) take(x, ld(row + c * b.s1) ^ b.flip, c == b.key);
  }
}

__global__ void __launch_bounds__(PROBE_THREADS)
narrow_extremes_kernel(ProbeBuf b1, ProbeBuf b2, int64_t* __restrict__ out,
                       int64_t* __restrict__ scratch) {
  const int64_t nthreads = (int64_t)gridDim.x * PROBE_THREADS;
  const int64_t t = (int64_t)blockIdx.x * PROBE_THREADS + threadIdx.x;
  Extremes x = none();
  if (b1.vec) scan_vec(b1, x, t, nthreads); else scan_rows(b1, x, t, nthreads);
  if (b2.vec) scan_vec(b2, x, t, nthreads); else scan_rows(b2, x, t, nthreads);
  x = block_reduce(x);

  // scratch: the ticket in a 16-byte header, then 4 int64 a block.
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch);
  int64_t* parts = scratch + 2;
  __shared__ bool last;
  if (threadIdx.x == 0) {
    int64_t* mine = parts + 4 * (int64_t)blockIdx.x;
    mine[0] = x.kmin;
    mine[1] = x.kmax;
    mine[2] = x.amin;
    mine[3] = x.amax;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  x = none();
  for (int64_t j = threadIdx.x; j < gridDim.x; j += PROBE_THREADS) {
    const long long* rec = reinterpret_cast<const long long*>(parts + 4 * j);
    combine(x, Extremes{(int64_t)__ldcg(rec), (int64_t)__ldcg(rec + 1), (int64_t)__ldcg(rec + 2),
                        (int64_t)__ldcg(rec + 3)});
  }
  x = block_reduce(x);
  if (threadIdx.x == 0) {
    out[0] = x.kmin;
    out[1] = x.amin;
    out[2] = x.kmax;
    out[3] = x.amax;
    *ticket = 0;  // ready for the next launch on this scratch
  }
}

// Blocks of one wave on the current device, found once per device.
int wave_blocks() {
  static int blocks[PROBE_MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= PROBE_MAX_DEVICES) return 1;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, narrow_extremes_kernel, PROBE_THREADS, 0);
    const int wave = sms * per_sm;
    blocks[dev] = wave < 1 ? 1 : (wave > PROBE_MAX_BLOCKS ? PROBE_MAX_BLOCKS : wave);
  }
  return blocks[dev];
}

bool make_buf(const void* base, int64_t rows, int ncol, int64_t s0, int64_t s1, int key,
              int is_unsigned, int contiguous, ProbeBuf* b, int64_t* units) {
  if (base == nullptr || rows < 1 || ncol < 1 || key < 0 || key >= ncol || s0 < 0 || s1 < 0) {
    return false;
  }
  const bool vec = contiguous && reinterpret_cast<uintptr_t>(base) % 16 == 0;
  *b = ProbeBuf{static_cast<const int64_t*>(base), rows, s0, s1, ncol, key,
                is_unsigned ? INT64_MIN : (int64_t)0, vec ? 1 : 0};
  *units = vec ? (rows * ncol / 2 + PROBE_UNROLL - 1) / PROBE_UNROLL : rows;
  return true;
}

}  // namespace

extern "C" int smj_probe_max_blocks() { return PROBE_MAX_BLOCKS; }

// d1, d2: int64 or uint64 (is_unsigned) [rows, ncol] views, s0 and s1 their
// strides in elements, `contiguous` when the rows follow each other with no
// gap; rows and ncol >= 1, 0 <= key < ncol. out: int64 [4], written as
// (key min, value min, key max, value max). scratch: int64 [2 + 4 *
// PROBE_MAX_BLOCKS], 16-byte aligned, zeroed before its first launch and
// used by one stream at a time.
extern "C" int smj_narrow_extremes(const void* d1, int64_t rows1, int ncol1, int64_t s01,
                                   int64_t s11, int key1, int unsigned1, int contiguous1,
                                   const void* d2, int64_t rows2, int ncol2, int64_t s02,
                                   int64_t s12, int key2, int unsigned2, int contiguous2,
                                   void* out, void* scratch, void* stream) {
  ProbeBuf b1, b2;
  int64_t units1 = 0, units2 = 0;
  if (!make_buf(d1, rows1, ncol1, s01, s11, key1, unsigned1, contiguous1, &b1, &units1) ||
      !make_buf(d2, rows2, ncol2, s02, s12, key2, unsigned2, contiguous2, &b2, &units2) ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t units = units1 > units2 ? units1 : units2;
  int64_t blocks = (units + PROBE_THREADS - 1) / PROBE_THREADS;
  const int wave = wave_blocks();
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;  // buffers of one element each: the tails alone
  narrow_extremes_kernel<<<(unsigned)blocks, PROBE_THREADS, 0, (cudaStream_t)stream>>>(
      b1, b2, static_cast<int64_t*>(out), static_cast<int64_t*>(scratch));
  return (int)cudaGetLastError();
}
