// LSD radix sorts of int32 keys with int32 payloads, for the PyTorch port:
// the per-tile sort and the global sort, over one digit-ranking routine.
//
// radix_tile_kernel replaces the TPU kernel
// pim_sort_merge_join_tpu/ops/pallas/radix_sort.py _radix_tile_kernel
// (launched by radix_tile_sort): each `tile`-element tile is sorted stably
// by its key, one digit of `digit_bits` bits per pass, least significant
// first, for ceil(key_bits / digit_bits) passes. The digit of a pass is
// (key >> shift) & (2^digit_bits - 1) on the int32 key, exactly as on the
// TPU, so a key is ordered by its low bits read as unsigned and a negative
// key sorts after the non-negative ones. Payload operands follow their key.
//
// radix_hist_kernel, radix_hist_scan_kernel and radix_pass_kernel are the
// same file's global sort (xla_lsd_radix_sort there, plain XLA with a
// serialized scatter): a whole-array stable counting sort per digit. They
// have no TPU kernel behind them; the card has the scatter the TPU lacked.
//
// The TPU permuted a tile through one-hot matmuls. Here a tile lives in a
// block's registers, warp-striped: warp w holds elements
// [w * 32 * ITEMS, (w + 1) * 32 * ITEMS) of the tile, its item i the 32
// elements from i * 32 on, one per lane, so every load and store of a
// warp is one contiguous piece. One pass ranks the tile (rank_tile):
//   1. per warp, item by item in order: the lanes that share a digit find
//      each other by one ballot per digit bit; the lowest of them reads the
//      warp's running count of that digit from shared memory and adds the
//      group's size; a lane's rank inside its warp is that count plus the
//      peers below it;
//   2. per digit, an exclusive prefix over the warps in order, the tile's
//      histogram, and its exclusive scan over the digits by one warp;
//   3. rank = digit base + warps before + rank inside the warp: stable.
// The elements then go through shared memory once, written at their rank
// as one 8-byte (key, second word) element and read back warp-striped. The
// second word is the payload when there is exactly one, else the position
// inside the tile, by which the payload operands are fetched at the end
// from a copy of their tile in shared memory, so device memory sees only
// contiguous reads and writes. A pass whose digit is the same in the whole
// tile is the identity and is skipped: the OR and the AND of the tile's
// keys, taken once, tell (digit_is_constant in ops/kernels/radix_sort.py).
//
// The global sort is one histogram launch for all passes (block-private
// counts in shared memory, one atomicAdd per block and digit), a scan of
// each pass's histogram, and one launch per pass: a block takes a ticket
// (so a block only ever waits for blocks that already run), ranks its tile
// with rank_tile, publishes its per-digit counts, looks back over the
// earlier tiles for each digit's prefix (one thread per digit; a record is
// one 32-bit word, status in the top two bits, moved by one relaxed
// access; the walk ends at the nearest inclusive prefix), orders the tile
// by digit in shared memory and writes each digit's run to
// base[digit] + prefix[digit] on. Between passes key and payload travel as
// one 8-byte element, so a digit's run is one contiguous piece of one
// array. Nothing is read back by the host between the launches.
//
// What bounds them on an H100: by bytes each sort reads and writes its
// operands once (0.0955 ms for 20M x 2 int32); the global sort moves them
// once per pass plus one read of the key. The ranking, not the bytes, is
// the larger cost: per pass and element 8 ballots and one shared-memory
// round trip in a chain of ITEMS steps per warp, hidden by the other warps
// of the SM. Times are in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

#define SMJ_RADIX_MAX_OPS 8
#define SMJ_RADIX_MAX_SMEM 232448  // the H100's shared memory per block

// The tile kernel's block shapes: X(largest tile, threads, items per
// thread), in rising order; a tile takes the first that holds it. Mirrored
// by TILE_CONFIGS in ops/kernels/radix_sort.py.
#define SMJ_RADIX_CONFIGS(X) \
  X(512, 64, 8)              \
  X(1024, 64, 16)            \
  X(2048, 128, 16)           \
  X(4096, 256, 16)           \
  X(8192, 512, 16)           \
  X(16384, 1024, 16)

// Resident threads per SM the compiler must leave registers for in the
// tile kernel: 1024 is 64 registers a thread.
#define SMJ_RADIX_TILE_THREADS_PER_SM 1024
#define SMJ_RADIX_TILE_BLOCKS_PER_SM(threads) \
  (SMJ_RADIX_TILE_THREADS_PER_SM / (threads) > 0 ? SMJ_RADIX_TILE_THREADS_PER_SM / (threads) : 1)

// The global sort's block: SMJ_LSD_THREADS x SMJ_LSD_ITEMS elements a tile.
#define SMJ_LSD_THREADS 512
#define SMJ_LSD_ITEMS 16
#define SMJ_LSD_BLOCKS_PER_SM 2
// Kernels are built for a digit width known at compile time, 8 bits, and
// for any other width read at run time.
#define SMJ_RADIX_BITS_OF(digit_bits) ((digit_bits) == 8 ? 8 : 0)
#define SMJ_LSD_TILE (SMJ_LSD_THREADS * SMJ_LSD_ITEMS)
#define SMJ_LSD_HEADER 32  // ints before the histograms: one ticket per pass
#define SMJ_LSD_HIST_THREADS 256
#define SMJ_LSD_HIST_MAX_SMEM 49152

static_assert(SMJ_LSD_THREADS % 32 == 0 && SMJ_LSD_THREADS <= 1024, "whole warps");

// Every kernel's dynamic shared memory.
extern __shared__ __align__(16) unsigned char smj_radix_smem[];

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned ST_AGGREGATE = 1u << 30;  // the tile's own count of a digit
constexpr unsigned ST_PREFIX = 2u << 30;     // the count up to and including the tile
constexpr unsigned ST_MASK = 3u << 30;       // 0 in both bits: not written yet
constexpr unsigned SPIN_PAUSE_NS = 20;

struct RadixOps {
  const int32_t* src[SMJ_RADIX_MAX_OPS];
  int32_t* dst[SMJ_RADIX_MAX_OPS];
  int nops;
};

__device__ __forceinline__ int digit_of(int32_t key, int shift, int v) {
  return (key >> shift) & (v - 1);
}

// Ranks of one tile's elements within their warp, the warps' prefixes, the
// tile's histogram and its exclusive scan. `key` holds the thread's
// elements in the warp-striped order; elements from `count` on do not
// exist. On return, for an element with digit d held by warp w as item i:
//   its place in the tile ordered stably by digit is
//   base[d] + wc[w * v + d] + packed_rank(rk, i),
// tot[d] is the number of elements with digit d, and a barrier has passed.
// wc: [THREADS / 32][v], tot and base: [v], all in shared memory.
template <int THREADS, int ITEMS, int BITS>
__device__ __forceinline__ void rank_tile(const int32_t (&key)[ITEMS], int count, int shift,
                                          int bits_rt, int* wc, int* tot, int* base,
                                          unsigned (&rk)[(ITEMS + 1) / 2]) {
  constexpr int WARPS = THREADS / 32;
  const int bits = BITS ? BITS : bits_rt;
  const int v = 1 << bits;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lower_lanes = (1u << lane) - 1u;
  int* mine = wc + warp * v;
  for (int d = lane; d < v; d += 32) mine[d] = 0;
  __syncwarp();
  const int w0 = warp * (32 * ITEMS);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if ((i & 1) == 0) rk[i >> 1] = 0;
    if (w0 + i * 32 >= count) continue;  // the whole warp is past the end
    const bool valid = w0 + i * 32 + lane < count;
    const int d = digit_of(key[i], shift, v);
    unsigned peers = __ballot_sync(FULL, valid);
#pragma unroll
    for (int b = 0; b < bits; ++b) {
      const int bit = (d >> b) & 1;
      // The lanes with this bit as here: the ballot, or its complement.
      peers &= __ballot_sync(FULL, bit) ^ (unsigned)(bit - 1);
    }
    const int leader = __ffs(peers) - 1;
    int before = 0;
    if (valid && leader == lane) {
      before = mine[d];
      mine[d] = before + __popc(peers);
    }
    before = __shfl_sync(FULL, before, valid ? leader : lane);
    rk[i >> 1] |= (unsigned)(before + __popc(peers & lower_lanes)) << ((i & 1) * 16);
    __syncwarp();  // the next item's leader may be another lane
  }
  __syncthreads();
  for (int d = tid; d < v; d += THREADS) {
    int s = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int c = wc[w * v + d];
      wc[w * v + d] = s;
      s += c;
    }
    tot[d] = s;
  }
  __syncthreads();
  if (warp == 0) {
    const int per = (v + 31) >> 5;
    const int d0 = min(lane * per, v), d1 = min(d0 + per, v);
    int local = 0;
    for (int d = d0; d < d1; ++d) local += tot[d];
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - local;
    for (int d = d0; d < d1; ++d) {
      base[d] = run;
      run += tot[d];
    }
  }
  __syncthreads();
}

template <int ITEMS>
__device__ __forceinline__ int packed_rank(const unsigned (&rk)[(ITEMS + 1) / 2], int i) {
  return (int)((rk[i >> 1] >> ((i & 1) * 16)) & 0xffffu);
}

template <int THREADS, int ITEMS, int BITS>
__global__ void __launch_bounds__(THREADS, SMJ_RADIX_TILE_BLOCKS_PER_SM(THREADS))
radix_tile_kernel(RadixOps a, int tile, int bits_rt, int npass) {
  constexpr int WARPS = THREADS / 32;
  const int bits = BITS ? BITS : bits_rt;
  const int v = 1 << bits;
  int2* elems = reinterpret_cast<int2*>(smj_radix_smem);  // [tile]
  int* wc = reinterpret_cast<int*>(elems + tile);         // [WARPS][v]
  int* tot = wc + WARPS * v;                              // [v]
  int* base = tot + v;                                    // [v]
  int* bits_seen = base + v;                              // the keys' OR, their AND
  const int64_t gbase = (int64_t)blockIdx.x * tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int e0 = warp * (32 * ITEMS) + lane;
  // One payload rides as the element's second word; more are fetched at the
  // end by the position in the tile, which then is the second word.
  const bool carry = a.nops == 2;

  if (tid == 0) {
    bits_seen[0] = 0;
    bits_seen[1] = -1;
  }
  __syncthreads();
  int32_t key[ITEMS], second[ITEMS];
  int any = 0, all = -1;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = e0 + i * 32;
    key[i] = 0;
    second[i] = e;
    if (e < tile) {
      key[i] = __ldg(a.src[0] + gbase + e);
      if (carry) second[i] = __ldg(a.src[1] + gbase + e);
      any |= key[i];
      all &= key[i];
    }
  }
  any = (int)__reduce_or_sync(FULL, (unsigned)any);
  all = (int)__reduce_and_sync(FULL, (unsigned)all);
  if (lane == 0) {
    atomicOr(&bits_seen[0], any);
    atomicAnd(&bits_seen[1], all);
  }
  __syncthreads();
  const int differ = bits_seen[0] ^ bits_seen[1];

  for (int pass = 0; pass < npass; ++pass) {
    const int shift = pass * bits;
    if (((differ >> shift) & (v - 1)) == 0) continue;  // one digit in the whole tile
    unsigned rk[(ITEMS + 1) / 2];
    rank_tile<THREADS, ITEMS, BITS>(key, tile, shift, bits_rt, wc, tot, base, rk);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (e0 + i * 32 < tile) {
        const int d = digit_of(key[i], shift, v);
        elems[base[d] + wc[warp * v + d] + packed_rank<ITEMS>(rk, i)] =
            make_int2(key[i], second[i]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (e0 + i * 32 < tile) {
        const int2 x = elems[e0 + i * 32];
        key[i] = x.x;
        second[i] = x.y;
      }
    }
    // The next pass's ranking has barriers before anything is written here.
  }

#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = e0 + i * 32;
    if (e < tile) {
      a.dst[0][gbase + e] = key[i];
      if (carry) a.dst[1][gbase + e] = second[i];
    }
  }
  if (carry) return;
  int32_t* plane = reinterpret_cast<int32_t*>(elems);
  for (int op = 1; op < a.nops; ++op) {
    __syncthreads();  // the elements, or the last operand's plane, are read
    for (int e = tid; e < tile; e += THREADS) plane[e] = __ldg(a.src[op] + gbase + e);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int e = e0 + i * 32;
      if (e < tile) a.dst[op][gbase + e] = plane[second[i]];
    }
  }
}

// --- the global sort -----------------------------------------------------------

__device__ __forceinline__ unsigned load_record(const unsigned* p) {
  unsigned r;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(r) : "l"(p) : "memory");
  return r;
}
__device__ __forceinline__ void store_record(unsigned* p, unsigned r) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" : : "l"(p), "r"(r) : "memory");
}

// Every pass's digit counts of the whole key, from one read of it:
// hist[pass * v + digit], zeroed by the caller.
template <int BITS>
__global__ void __launch_bounds__(SMJ_LSD_HIST_THREADS)
radix_hist_kernel(const int32_t* __restrict__ keys, int n, int bits_rt, int npass, int* hist) {
  const int bits = BITS ? BITS : bits_rt;
  const int v = 1 << bits;
  int* h = reinterpret_cast<int*>(smj_radix_smem);  // [npass][v]
  for (int j = threadIdx.x; j < npass * v; j += blockDim.x) h[j] = 0;
  __syncthreads();
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int32_t key = __ldg(keys + i);
    for (int p = 0; p < npass; ++p) atomicAdd(&h[p * v + digit_of(key, p * bits, v)], 1);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < npass * v; j += blockDim.x) {
    if (h[j] != 0) atomicAdd(&hist[j], h[j]);
  }
}

// Each pass's histogram to its exclusive scan, in place: block = pass, one warp.
__global__ void radix_hist_scan_kernel(int* hist, int v) {
  int* h = hist + blockIdx.x * v;
  const int lane = threadIdx.x;
  const int per = (v + 31) >> 5;
  const int d0 = min(lane * per, v), d1 = min(d0 + per, v);
  int local = 0;
  for (int d = d0; d < d1; ++d) local += h[d];
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  int run = incl - local;
  for (int d = d0; d < d1; ++d) {
    const int c = h[d];
    h[d] = run;
    run += c;
  }
}

struct PassArgs {
  // The input: key and second word apart (in_v may be null), or together.
  const int32_t* in_k;
  const int32_t* in_v;
  const int2* in_kv;
  // The output, likewise.
  int32_t* out_k;
  int32_t* out_v;
  int2* out_kv;
  int n;
  int shift;
  int bits;
  int gen_pos;          // the second word is the element's index in the input
  const int* digit_base;  // [v]: elements of the whole array with a smaller digit
  unsigned* recs;       // [tiles][v], zeroed
  int* ticket;          // zeroed
};

// The count of digit d over tiles 0 .. t-1.
__device__ __forceinline__ unsigned look_back(const unsigned* recs, int t, int v, int d) {
  unsigned before = 0;
  for (int j = t - 1; j >= 0; --j) {
    const unsigned* p = recs + (size_t)j * v + d;
    unsigned r = load_record(p);
    while ((r & ST_MASK) == 0) {
      __nanosleep(SPIN_PAUSE_NS);
      r = load_record(p);
    }
    before += r & ~ST_MASK;
    if ((r & ST_MASK) == ST_PREFIX) break;
  }
  return before;
}

template <int BITS>
__global__ void __launch_bounds__(SMJ_LSD_THREADS, SMJ_LSD_BLOCKS_PER_SM)
radix_pass_kernel(PassArgs p) {
  constexpr int THREADS = SMJ_LSD_THREADS, ITEMS = SMJ_LSD_ITEMS, WARPS = THREADS / 32;
  const int bits = BITS ? BITS : p.bits;
  const int v = 1 << bits;
  int2* elems = reinterpret_cast<int2*>(smj_radix_smem);  // [SMJ_LSD_TILE]
  int* wc = reinterpret_cast<int*>(elems + SMJ_LSD_TILE);  // [WARPS][v]
  int* tot = wc + WARPS * v;                               // [v]
  int* base = tot + v;                                     // [v]
  int* first_out = base + v;                               // [v]
  __shared__ int s_ticket;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) s_ticket = atomicAdd(p.ticket, 1);
  __syncthreads();
  const int t = s_ticket;
  const int tile0 = t * SMJ_LSD_TILE;
  const int count = min(SMJ_LSD_TILE, p.n - tile0);
  const int e0 = warp * (32 * ITEMS) + lane;

  int32_t key[ITEMS], second[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int e = e0 + i * 32;
    key[i] = 0;
    second[i] = tile0 + e;
    if (e < count) {
      if (p.in_kv != nullptr) {
        const int2 x = __ldg(p.in_kv + tile0 + e);
        key[i] = x.x;
        second[i] = x.y;
      } else {
        key[i] = __ldg(p.in_k + tile0 + e);
        if (!p.gen_pos && p.in_v != nullptr) second[i] = __ldg(p.in_v + tile0 + e);
      }
    }
  }

  unsigned rk[(ITEMS + 1) / 2];
  rank_tile<THREADS, ITEMS, BITS>(key, count, p.shift, p.bits, wc, tot, base, rk);

  // Publish the tile's counts first, for whoever looks back at this tile;
  // then each digit's thread looks back itself.
  unsigned* mine = p.recs + (size_t)t * v;
  for (int d = tid; d < v; d += THREADS) {
    store_record(mine + d, (t == 0 ? ST_PREFIX : ST_AGGREGATE) | (unsigned)tot[d]);
  }
  for (int d = tid; d < v; d += THREADS) {
    unsigned before = 0;
    if (t > 0) {
      before = look_back(p.recs, t, v, d);
      store_record(mine + d, ST_PREFIX | (before + (unsigned)tot[d]));
    }
    // Where the tile's first element of digit d goes, less its place in the tile.
    first_out[d] = p.digit_base[d] + (int)before - base[d];
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    if (e0 + i * 32 < count) {
      const int d = digit_of(key[i], p.shift, v);
      elems[base[d] + wc[warp * v + d] + packed_rank<ITEMS>(rk, i)] = make_int2(key[i], second[i]);
    }
  }
  __syncthreads();
  // The tile in digit order: neighbouring threads write neighbouring places.
  for (int e = tid; e < count; e += THREADS) {
    const int2 x = elems[e];
    const int dest = first_out[digit_of(x.x, p.shift, v)] + e;
    if (p.out_kv != nullptr) {
      p.out_kv[dest] = x;
    } else {
      p.out_k[dest] = x.x;
      if (p.out_v != nullptr) p.out_v[dest] = x.y;
    }
  }
}

// --- launches --------------------------------------------------------------------

inline int64_t tile_smem_bytes(int64_t tile, int threads, int digit_bits) {
  // The elements, the warps' digit counts, the histogram and its scan, and
  // the keys' OR and AND.
  return tile * 8 + ((int64_t)(threads / 32 + 2) << digit_bits) * 4 + 16;
}

inline int64_t lsd_smem_bytes(int digit_bits) {
  // As above, and where each digit's run goes.
  return (int64_t)SMJ_LSD_TILE * 8 + ((int64_t)(SMJ_LSD_THREADS / 32 + 3) << digit_bits) * 4;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int64_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int THREADS, int ITEMS>
int launch_tile(const RadixOps& a, int64_t n, int tile, int digit_bits, int npass,
                cudaStream_t st) {
  const int64_t smem = tile_smem_bytes(tile, THREADS, digit_bits);
  if (smem > SMJ_RADIX_MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = SMJ_RADIX_BITS_OF(digit_bits) == 8 ? radix_tile_kernel<THREADS, ITEMS, 8>
                                                   : radix_tile_kernel<THREADS, ITEMS, 0>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  kernel<<<(unsigned)(n / tile), THREADS, (size_t)smem, st>>>(a, tile, digit_bits, npass);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int smj_radix_max_ops() { return SMJ_RADIX_MAX_OPS; }

extern "C" int64_t smj_radix_max_smem() { return SMJ_RADIX_MAX_SMEM; }

// The block that sorts a tile of this size: its threads, or 0 for none.
extern "C" int smj_radix_tile_threads(int tile) {
#define SMJ_RADIX_THREADS_OF(CAP, THREADS, ITEMS) \
  if (tile <= (CAP)) return (THREADS);
  SMJ_RADIX_CONFIGS(SMJ_RADIX_THREADS_OF)
#undef SMJ_RADIX_THREADS_OF
  return 0;
}

extern "C" int smj_radix_tile_items(int tile) {
#define SMJ_RADIX_ITEMS_OF(CAP, THREADS, ITEMS) \
  if (tile <= (CAP)) return (ITEMS);
  SMJ_RADIX_CONFIGS(SMJ_RADIX_ITEMS_OF)
#undef SMJ_RADIX_ITEMS_OF
  return 0;
}

extern "C" int64_t smj_radix_smem_bytes(int64_t tile, int digit_bits) {
  const int threads = smj_radix_tile_threads((int)tile);
  return threads == 0 ? -1 : tile_smem_bytes(tile, threads, digit_bits);
}

// Sorts every `tile` elements of the nops int32 operands by operand 0
// (n a multiple of tile), from srcs into dsts.
extern "C" int smj_radix_tile_sort(const void* const* srcs, void* const* dsts, int nops,
                                   int64_t n, int tile, int digit_bits, int npass,
                                   void* stream) {
  if (nops < 1 || nops > SMJ_RADIX_MAX_OPS || tile < 1 || n % tile != 0 || digit_bits < 1 ||
      digit_bits > 16 || npass < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RadixOps a;
  for (int op = 0; op < nops; ++op) {
    a.src[op] = static_cast<const int32_t*>(srcs[op]);
    a.dst[op] = static_cast<int32_t*>(dsts[op]);
  }
  a.nops = nops;
  const cudaStream_t st = (cudaStream_t)stream;
#define SMJ_RADIX_LAUNCH(CAP, THREADS, ITEMS)                                    \
  static_assert((CAP) == (THREADS) * (ITEMS) && (THREADS) % 32 == 0, "a block holds its tile"); \
  if (tile <= (CAP)) return launch_tile<THREADS, ITEMS>(a, n, tile, digit_bits, npass, st);
  SMJ_RADIX_CONFIGS(SMJ_RADIX_LAUNCH)
#undef SMJ_RADIX_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" int smj_lsd_threads() { return SMJ_LSD_THREADS; }

extern "C" int smj_lsd_items() { return SMJ_LSD_ITEMS; }

extern "C" int64_t smj_lsd_smem_bytes(int digit_bits) { return lsd_smem_bytes(digit_bits); }

// Zeroed int32 words of state for one sort: the passes' tickets, their
// histograms, and one record per pass, tile and digit.
extern "C" int64_t smj_lsd_state_words(int64_t n, int digit_bits, int npass) {
  const int64_t tiles = (n + SMJ_LSD_TILE - 1) / SMJ_LSD_TILE;
  return SMJ_LSD_HEADER + ((int64_t)npass << digit_bits) * (1 + tiles);
}

// The stable sort of n keys by their low npass * digit_bits bits, one
// counting sort per digit, least significant first. in_v: the payload, or
// null with has_val = 0 (keys alone) or gen_pos = 1 (the payload is the
// element's index). tmp_a, tmp_b: n elements each between the passes
// (8 bytes with a payload, else 4); tmp_b may be null up to two passes,
// tmp_a for one. state: smj_lsd_state_words zeroed int32.
extern "C" int smj_lsd_radix_sort(const void* in_k, const void* in_v, void* out_k, void* out_v,
                                  void* tmp_a, void* tmp_b, void* state, int64_t n,
                                  int digit_bits, int npass, int has_val, int gen_pos,
                                  void* stream) {
  const int v = 1 << digit_bits;
  if (n < 1 || n >= (1 << 30) || digit_bits < 1 || digit_bits > 16 || npass < 1 ||
      npass > SMJ_LSD_HEADER || (int64_t)npass * v * 4 > SMJ_LSD_HIST_MAX_SMEM ||
      lsd_smem_bytes(digit_bits) > SMJ_RADIX_MAX_SMEM || (has_val && !gen_pos && in_v == nullptr) ||
      (has_val && out_v == nullptr) || (npass > 1 && tmp_a == nullptr) ||
      (npass > 2 && tmp_b == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (int)((n + SMJ_LSD_TILE - 1) / SMJ_LSD_TILE);
  int* tickets = static_cast<int*>(state);
  int* hist = tickets + SMJ_LSD_HEADER;
  unsigned* recs = reinterpret_cast<unsigned*>(hist + (int64_t)npass * v);

  const int per_block = SMJ_LSD_HIST_THREADS * 16;
  const int64_t want_blocks = (n + per_block - 1) / per_block;
  const unsigned hist_blocks = (unsigned)(want_blocks < 132 * 8 ? want_blocks : 132 * 8);
  const size_t hist_smem = (size_t)npass * v * 4;
  if (SMJ_RADIX_BITS_OF(digit_bits) == 8) {
    radix_hist_kernel<8><<<hist_blocks, SMJ_LSD_HIST_THREADS, hist_smem, st>>>(
        static_cast<const int32_t*>(in_k), (int)n, digit_bits, npass, hist);
  } else {
    radix_hist_kernel<0><<<hist_blocks, SMJ_LSD_HIST_THREADS, hist_smem, st>>>(
        static_cast<const int32_t*>(in_k), (int)n, digit_bits, npass, hist);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  radix_hist_scan_kernel<<<(unsigned)npass, 32, 0, st>>>(hist, v);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto kernel = SMJ_RADIX_BITS_OF(digit_bits) == 8 ? radix_pass_kernel<8> : radix_pass_kernel<0>;
  const int64_t smem = lsd_smem_bytes(digit_bits);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  void* tmp[2] = {tmp_a, tmp_b};
  for (int pass = 0; pass < npass; ++pass) {
    PassArgs p = {};
    if (pass == 0) {
      p.in_k = static_cast<const int32_t*>(in_k);
      p.in_v = static_cast<const int32_t*>(in_v);
    } else if (has_val) {
      p.in_kv = static_cast<const int2*>(tmp[(pass - 1) & 1]);
    } else {
      p.in_k = static_cast<const int32_t*>(tmp[(pass - 1) & 1]);
    }
    if (pass == npass - 1) {
      p.out_k = static_cast<int32_t*>(out_k);
      p.out_v = has_val ? static_cast<int32_t*>(out_v) : nullptr;
    } else if (has_val) {
      p.out_kv = static_cast<int2*>(tmp[pass & 1]);
    } else {
      p.out_k = static_cast<int32_t*>(tmp[pass & 1]);
    }
    p.n = (int)n;
    p.shift = pass * digit_bits;
    p.bits = digit_bits;
    p.gen_pos = pass == 0 && gen_pos;
    p.digit_base = hist + (int64_t)pass * v;
    p.recs = recs + (int64_t)pass * tiles * v;
    p.ticket = tickets + pass;
    kernel<<<(unsigned)tiles, SMJ_LSD_THREADS, (size_t)smem, st>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
