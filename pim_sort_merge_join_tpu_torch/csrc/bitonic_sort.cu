// Bitonic sort of int32 (key, val) pairs for the PyTorch port.
//
// Replaces the TPU kernel pim_sort_merge_join_tpu/ops/pallas/sort_kernel.py
// _sort_kernel (launched by _sort_pairs_pallas_p2): the bitonic network of
// _substeps / _compare_exchange over a power-of-two array, compared
// lexicographically on (key, val), the pair at (i, i ^ j) ordered ascending
// iff (i & k) == 0 for the global index i. With val = the row index the
// result is exactly a stable sort by key.
//
// What bounds it on an H100: the TPU kept all of n <= 2^21 pairs in VMEM
// for the whole network; a block here holds at most 227 KB of shared memory,
// so the network cannot stay on chip, and its log2(n) * (log2(n) + 1) / 2
// substeps must not each become a trip through device memory, nor each a
// trip through shared memory. The design:
//   - One 64-bit element, (key ^ sign) << 32 | (val ^ sign): one unsigned
//     compare, one 8-byte access, one array. The first pass packs it from
//     the two int32 arrays and the last pass unpacks it, so no pass over
//     device memory is spent on the format.
//   - One kernel, bitonic_pass_kernel, runs a group of substeps on a tile of
//     2^LOG_TILE elements in shared memory. Which elements a block holds is
//     a choice of index bits: the low `chunk` bits (a contiguous piece of at
//     least 2^LOG_MIN_CHUNK elements, 128 bytes, so that a warp's accesses
//     fill whole lines) and the LOG_TILE - chunk bits from bit `lo` up. With
//     chunk == lo == LOG_TILE that is a contiguous tile (a local pass: all
//     substeps with j < tile); otherwise a strided pass, which runs up to
//     LOG_TILE - LOG_MIN_CHUNK substeps with j >= tile on chip. So a stage k
//     above the tile is one strided and one local pass (17 launches at 2^21),
//     and the 16 MB of elements stay in the 50 MB L2 between them.
//   - Registers between barriers. In a round a thread holds the 2^LOG_ITEMS
//     elements whose tile indices differ in LOG_ITEMS consecutive bits, and
//     runs the substeps on those bits in registers; shared memory and a
//     barrier come only between rounds, to regroup. Slots are padded by one
//     per 2^LOG_ITEMS, which keeps a round's accesses off each other's banks.
//   - Lanes below the registers. The lowest round holds tile bits 5..8 in
//     registers; a warp's 32 lanes then span bits 0..4, and the substeps on
//     those go from lane to lane by __shfl_xor_sync. So the last nine
//     substeps of a stage need no regrouping, and a tile's own sort none
//     before stage 2^10.
//   - No staging. In every round but that of a thread's own 16 neighbours
//     the lanes of a warp hold neighbouring elements, and with the lanes on
//     the lowest bits no pass begins or ends in such a round: a pass loads
//     its first round's registers straight from device memory and stores its
//     last round's straight back, every access of a warp 256 contiguous
//     bytes. Shared memory only regroups: once in a pass above the tile.
//   - The direction of a compare comes from bit log2(k) of the element's
//     global index, as in the reference: the same for all of a thread's
//     elements, except in the first stages of a tile's own sort, where it is
//     one of the thread's own index bits. (Holding the descending side
//     complemented, so that no compare tests a direction, was tried and is
//     no faster.)
// The schedule of passes is made by ops/kernels/bitonic_sort.py
// (bitonic_schedule), which plans with the same LOG_TILE and LOG_MIN_CHUNK
// and refuses a library that differs.

#include <cstdint>
#include <cuda_runtime.h>

#define SMJ_BITONIC_LOG_TILE 13
#define SMJ_BITONIC_LOG_ITEMS 4
#define SMJ_BITONIC_BLOCKS_PER_SM 2
#define SMJ_BITONIC_LOG_MIN_CHUNK 4

namespace {

constexpr int LT = SMJ_BITONIC_LOG_TILE;
constexpr int LI = SMJ_BITONIC_LOG_ITEMS;
constexpr int TILE = 1 << LT;
constexpr int ITEMS = 1 << LI;
constexpr int THREADS = TILE / ITEMS;
constexpr size_t SHARED_BYTES = (size_t)(TILE + TILE / ITEMS) * sizeof(uint64_t);
constexpr uint32_t BIAS32 = 0x80000000u;

// The substeps on the five lowest tile bits go from lane to lane by warp
// shuffles.
constexpr int LANE_BITS = 5;

static_assert(LT > SMJ_BITONIC_LOG_MIN_CHUNK && LI >= 1 && LI <= 4 && LT >= 2 * LI &&
                  THREADS <= 1024 && LT >= LI + LANE_BITS,
              "bitonic tile and items per thread out of range");

__device__ __forceinline__ uint32_t slot(uint32_t l) { return l + (l >> LI); }

__device__ __forceinline__ uint64_t pack(int32_t key, int32_t val) {
  return ((uint64_t)((uint32_t)key ^ BIAS32) << 32) | ((uint32_t)val ^ BIAS32);
}

__device__ __forceinline__ int32_t key_of(uint64_t x) {
  return (int32_t)((uint32_t)(x >> 32) ^ BIAS32);
}

__device__ __forceinline__ int32_t val_of(uint64_t x) { return (int32_t)((uint32_t)x ^ BIAS32); }

// The thread's register indices whose bit q is set, as a mask.
__device__ __forceinline__ uint32_t index_bit_mask(int q) {
  uint32_t m = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if ((i >> q) & 1) m |= 1u << i;
  }
  return m;
}

// One substep on register bit Q: r[i] against r[i | 1 << Q], descending
// where bit i of `down` is set.
template <int Q>
__device__ __forceinline__ void compare_exchange(uint64_t (&r)[ITEMS], uint32_t down) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if ((i & (1 << Q)) == 0) {
      const uint64_t a = r[i], b = r[i | (1 << Q)];
      const bool swap = (a > b) != (((down >> i) & 1u) != 0);
      r[i] = swap ? b : a;
      r[i | (1 << Q)] = swap ? a : b;
    }
  }
}

// One substep on tile bit L < LANE_BITS of the lowest round, where a warp's
// lanes span the tile bits below the registers': every element against the
// same register of lane ^ (1 << L). The lane whose bit is clear keeps the
// smaller one where the direction is ascending.
__device__ __forceinline__ void lane_exchange(uint64_t (&r)[ITEMS], uint32_t down, int L) {
  const bool upper = ((threadIdx.x >> L) & 1u) != 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const uint64_t a = r[i];
    const uint64_t b = __shfl_xor_sync(0xffffffffu, a, 1 << L);
    const bool keep_max = upper != (((down >> i) & 1u) != 0);
    r[i] = (keep_max == (a > b)) ? a : b;
  }
}

// The substeps on tile bits hi..low of a round whose registers span tile
// bits p..p + LI - 1, highest first.
template <int Q>
__device__ __forceinline__ void round_substeps(uint64_t (&r)[ITEMS], uint32_t down, int p, int hi,
                                               int low) {
  if (p + Q <= hi && p + Q >= low) compare_exchange<Q>(r, down);
  if constexpr (Q > 0) round_substeps<Q - 1>(r, down, p, hi, low);
}

// Stages s = s_first..s_last (k = 2^s) on the block's elements: of stage s
// the substeps on the block's index bits from s - 1 down to the tile bit
// `tile_low`. Tile index l is global index
//   base | (l & (2^c - 1)) | ((l >> c) << lo),
// base made of the block index's bits at [c, lo) and from lo + LT - c up.
// `pack_in`: read (keys, vals) and not buf; `unpack_out`: write (out_k,
// out_v). Those four arrays hold the first `count` of the network's `n`
// elements; the others are the largest pair, which sorts to the tail and
// is never written out. buf holds all n.
__global__ void __launch_bounds__(THREADS, SMJ_BITONIC_BLOCKS_PER_SM)
bitonic_pass_kernel(const int32_t* __restrict__ keys, const int32_t* __restrict__ vals,
                    uint64_t* __restrict__ buf, int32_t* __restrict__ out_k,
                    int32_t* __restrict__ out_v, uint32_t n, uint32_t count, int s_first,
                    int s_last, int lo, int c, int tile_low, int pack_in, int unpack_out) {
  extern __shared__ __align__(16) uint64_t smj_bitonic_tile[];
  uint64_t* sm = smj_bitonic_tile;
  const uint32_t tid = threadIdx.x;
  const uint32_t cmask = (1u << c) - 1u;
  const int top = lo + LT - c;  // the first index bit above the block's own
  const uint32_t base = ((blockIdx.x & ((1u << (lo - c)) - 1u)) << c) |
                        ((blockIdx.x >> (lo - c)) << top);
  auto global_index = [&](uint32_t l) { return base | (l & cmask) | ((l >> c) << lo); };

  // r[i] is tile element lbase | i << cur_p. n < TILE leaves the rest of the
  // tile as padding that no stage s <= log2(n) lets near the data.
  const uint32_t n_in = pack_in ? count : n, n_out = unpack_out ? count : n;
  uint64_t r[ITEMS];
  int cur_p = -1;
  uint32_t lbase = 0;
  for (int s = s_first; s <= s_last; ++s) {
    const int bit = s - 1;  // the stage's highest substep, as an index bit
    int hi = bit >= top ? LT - 1 : (bit < c ? bit : bit - lo + c);
    while (hi >= tile_low) {
      // The lowest round keeps the registers above the LANE_BITS that a
      // warp's lanes span, and goes down to tile bit 0 without regrouping.
      const int p = hi >= LANE_BITS + LI ? hi - (LI - 1) : LANE_BITS;
      const int low = p > tile_low ? p : tile_low;
      if (p != cur_p) {
        const uint32_t to = ((tid >> p) << (p + LI)) | (tid & ((1u << p) - 1u));
        if (cur_p < 0) {
#pragma unroll
          for (int i = 0; i < ITEMS; ++i) {
            const uint32_t g = global_index(to | ((uint32_t)i << p));
            r[i] = g >= n_in ? ~0ull : (pack_in ? pack(keys[g], vals[g]) : buf[g]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < ITEMS; ++i) sm[slot(lbase | ((uint32_t)i << cur_p))] = r[i];
          __syncthreads();
#pragma unroll
          for (int i = 0; i < ITEMS; ++i) r[i] = sm[slot(to | ((uint32_t)i << p))];
        }
        lbase = to;
        cur_p = p;
      }
      // Descending where bit s of the global index is set: one of the
      // thread's own register bits only inside a tile's first stages.
      uint32_t down = ((global_index(lbase) >> s) & 1u) ? ~0u : 0u;
#pragma unroll
      for (int q = 0; q < LI; ++q) {
        const int tb = p + q;
        if ((tb < c ? tb : tb - c + lo) == s) down = index_bit_mask(q);
      }
      round_substeps<LI - 1>(r, down, p, hi, low);
      if (p == LANE_BITS) {
        for (int b = hi < LANE_BITS ? hi : LANE_BITS - 1; b >= tile_low; --b) {
          lane_exchange(r, down, b);
        }
        hi = tile_low - 1;
      } else {
        hi = low - 1;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const uint32_t g = global_index(lbase | ((uint32_t)i << cur_p));
    if (g < n_out) {
      if (unpack_out) {
        out_k[g] = key_of(r[i]);
        out_v[g] = val_of(r[i]);
      } else {
        buf[g] = r[i];
      }
    }
  }
}

int log2_exact(int64_t n) {
  int m = 0;
  while (((int64_t)1 << m) < n) ++m;
  return ((int64_t)1 << m) == n ? m : -1;
}

}  // namespace

extern "C" int smj_bitonic_log_tile() { return LT; }

extern "C" int smj_bitonic_log_min_chunk() { return SMJ_BITONIC_LOG_MIN_CHUNK; }

// The passes of a schedule over n = 2^m elements (2 <= n <= 2^30), launched
// one after the other from this one call (a launch per call from Python
// would leave the card waiting for the host). `passes` holds five ints per
// pass: s_first, s_last, lo, chunk, low_bit: stages s_first..s_last, of each
// the substeps on the index bits from s - 1 down to `low_bit` that a block
// holds. A block holds the index bits below `chunk` and the LOG_TILE - chunk
// bits from `lo` up. A local pass has chunk == lo == LOG_TILE and low_bit ==
// 0; a strided pass LOG_MIN_CHUNK <= chunk < LOG_TILE <= lo and low_bit ==
// lo. With `pack_first` the first pass reads (keys, vals), else buf; with
// `unpack_last` the last writes (out_k, out_v), else buf. Those arrays hold
// `count` <= n pairs: the network's other elements are the largest pair
// (INT32_MAX, INT32_MAX), made on the way in and dropped on the way out, so
// a caller that pads to a power of two copies nothing. Nothing is launched
// unless every pass is valid.
extern "C" int smj_bitonic_passes(const void* keys, const void* vals, void* buf, void* out_k,
                                  void* out_v, int64_t n, int64_t count, const int* passes,
                                  int npasses, int pack_first, int unpack_last, void* stream) {
  const int m = log2_exact(n);
  if (m < 1 || m > 30 || npasses < 1 || count < 1 || count > n) {
    return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < npasses; ++i) {
    const int s_first = passes[5 * i], s_last = passes[5 * i + 1], lo = passes[5 * i + 2],
              chunk = passes[5 * i + 3], low_bit = passes[5 * i + 4];
    if (s_first < 1 || s_last < s_first || s_last > m) return (int)cudaErrorInvalidValue;
    const bool local = chunk == LT && lo == LT && low_bit == 0;
    const bool strided = chunk >= SMJ_BITONIC_LOG_MIN_CHUNK && chunk < LT && lo >= LT &&
                         low_bit == lo && lo + LT - chunk <= m && s_first > lo;
    if (!local && !strided) return (int)cudaErrorInvalidValue;
    // Only a tile's own sort (stages up to LOG_TILE) runs several stages.
    if (s_first != s_last && !(local && s_last <= LT)) return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      bitonic_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SHARED_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = n > TILE ? n / TILE : 1;
  for (int i = 0; i < npasses; ++i) {
    const int chunk = passes[5 * i + 3];
    bitonic_pass_kernel<<<(unsigned)blocks, THREADS, SHARED_BYTES, (cudaStream_t)stream>>>(
        static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals),
        static_cast<uint64_t*>(buf), static_cast<int32_t*>(out_k), static_cast<int32_t*>(out_v),
        (uint32_t)n, (uint32_t)count, passes[5 * i], passes[5 * i + 1], passes[5 * i + 2], chunk,
        chunk == LT ? 0 : chunk, pack_first && i == 0, unpack_last && i == npasses - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
