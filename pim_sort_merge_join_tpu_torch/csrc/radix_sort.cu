// Per-tile LSD radix sort of int32 keys with int32 payloads, for the PyTorch port.
//
// Replaces the TPU kernel pim_sort_merge_join_tpu/ops/pallas/radix_sort.py
// _radix_tile_kernel (launched by radix_tile_sort): each `tile`-element
// tile is sorted stably by its key, one digit of `digit_bits` bits per
// pass, least significant first, for ceil(key_bits / digit_bits) passes.
// The digit of a pass is (key >> shift) & (2^digit_bits - 1) on the int32
// key, exactly as on the TPU, so a key is ordered by its low bits read as
// unsigned and a negative key sorts after the non-negative ones. Payload
// operands follow their key.
//
// What bounds it on an H100: the TPU has no vector scatter, so there each
// pass built one-hot matrices and permuted the tile through f32 matmuls.
// On the card the scatter is cheap in shared memory, and each tile is read
// from device memory once and written once. One block sorts one tile held
// in shared memory; each pass is
//   1. a digit histogram per warp, each warp over its own contiguous
//      segment of the tile (__match_any_sync groups the lanes that share a
//      digit; the lowest lane of a group adds the group's size);
//   2. per digit, an exclusive prefix over the warps in index order, then an
//      exclusive scan over the digits, which gives every (warp, digit) its
//      first output slot;
//   3. a stable scatter: each warp walks its segment 32 elements at a time
//      in order, and a lane's slot is its (warp, digit) slot plus the count
//      of lower lanes with the same digit (__popc of the match mask).
// Only the keys and the tile positions move through the passes; payloads
// are gathered once at the end from the tile in device memory. The launch
// is bound by the passes' shared-memory work, not by device memory.

#include <cstdint>
#include <cuda_runtime.h>

#define SMJ_RADIX_THREADS 256
#define SMJ_RADIX_WARPS (SMJ_RADIX_THREADS / 32)
#define SMJ_RADIX_MAX_OPS 8
#define SMJ_RADIX_MAX_SMEM 232448  // the H100's shared memory per block

namespace {

struct RadixOps {
  const int32_t* src[SMJ_RADIX_MAX_OPS];
  int32_t* dst[SMJ_RADIX_MAX_OPS];
  int nops;
};

inline int64_t smem_bytes(int64_t tile, int digit_bits) {
  // Two key and two position buffers, the warps' digit counts, the digit
  // bases, and the block scan's warp totals.
  return (4 * tile + (int64_t)(SMJ_RADIX_WARPS + 1) * (1 << digit_bits) + SMJ_RADIX_WARPS) * 4;
}

// Exclusive scan of x[0, v) in place by the whole block: each thread scans
// a contiguous run of entries, the runs' totals are scanned with warp
// shuffles, and each thread writes its run back with its offset.
__device__ void block_exclusive_scan(int32_t* x, int v, int32_t* warp_tot) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int per = (v + SMJ_RADIX_THREADS - 1) / SMJ_RADIX_THREADS;
  const int d0 = min(tid * per, v), d1 = min(d0 + per, v);
  int local = 0;
  for (int d = d0; d < d1; ++d) local += x[d];
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int t = lane < SMJ_RADIX_WARPS ? warp_tot[lane] : 0;
    int s = t;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < SMJ_RADIX_WARPS) warp_tot[lane] = s - t;
  }
  __syncthreads();
  int run = incl - local + warp_tot[warp];
  for (int d = d0; d < d1; ++d) {
    const int cnt = x[d];
    x[d] = run;
    run += cnt;
  }
}

__global__ void __launch_bounds__(SMJ_RADIX_THREADS)
radix_tile_kernel(RadixOps a, int tile, int digit_bits, int npass) {
  extern __shared__ int32_t smem[];
  const int v = 1 << digit_bits;
  int32_t* kin = smem;
  int32_t* kout = kin + tile;
  int32_t* iin = kout + tile;
  int32_t* iout = iin + tile;
  int32_t* wcount = iout + tile;  // [SMJ_RADIX_WARPS][v]
  int32_t* dbase = wcount + SMJ_RADIX_WARPS * v;  // [v]
  int32_t* warp_tot = dbase + v;                  // [SMJ_RADIX_WARPS]
  const int64_t base = (int64_t)blockIdx.x * tile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const unsigned lower_lanes = (1u << lane) - 1;
  const int seg = (tile + SMJ_RADIX_WARPS - 1) / SMJ_RADIX_WARPS;
  const int lo = min(warp * seg, tile), hi = min(lo + seg, tile);
  int32_t* mine = wcount + warp * v;

  for (int e = tid; e < tile; e += blockDim.x) {
    kin[e] = a.src[0][base + e];
    iin[e] = e;
  }
  __syncthreads();

  for (int pass = 0; pass < npass; ++pass) {
    const int shift = pass * digit_bits;
    // 1. this warp's digit counts over its segment.
    for (int d = lane; d < v; d += 32) mine[d] = 0;
    __syncwarp();
    for (int c = lo; c < hi; c += 32) {
      const int e = c + lane;
      const bool act = e < hi;
      // Inactive lanes take a digit no active lane has, so they group alone.
      const int dg = act ? (kin[e] >> shift) & (v - 1) : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, dg);
      if (act && (peers & lower_lanes) == 0) mine[dg] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // 2. prefix over the warps per digit, then over the digits.
    for (int d = tid; d < v; d += blockDim.x) {
      int s = 0;
      for (int w = 0; w < SMJ_RADIX_WARPS; ++w) {
        const int cnt = wcount[w * v + d];
        wcount[w * v + d] = s;
        s += cnt;
      }
      dbase[d] = s;
    }
    __syncthreads();
    block_exclusive_scan(dbase, v, warp_tot);
    __syncthreads();
    for (int d = lane; d < v; d += 32) mine[d] += dbase[d];
    __syncwarp();
    // 3. stable scatter, in index order within the warp's segment.
    for (int c = lo; c < hi; c += 32) {
      const int e = c + lane;
      const bool act = e < hi;
      const int dg = act ? (kin[e] >> shift) & (v - 1) : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, dg);
      if (act) {
        const int dest = mine[dg] + __popc(peers & lower_lanes);
        kout[dest] = kin[e];
        iout[dest] = iin[e];
      }
      __syncwarp();
      if (act && (peers & lower_lanes) == 0) mine[dg] += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    int32_t* t = kin;
    kin = kout;
    kout = t;
    t = iin;
    iin = iout;
    iout = t;
  }

  for (int e = tid; e < tile; e += blockDim.x) {
    a.dst[0][base + e] = kin[e];
    const int64_t from = base + iin[e];
    for (int op = 1; op < a.nops; ++op) a.dst[op][base + e] = a.src[op][from];
  }
}

}  // namespace

extern "C" int smj_radix_max_ops() { return SMJ_RADIX_MAX_OPS; }

extern "C" int64_t smj_radix_max_smem() { return SMJ_RADIX_MAX_SMEM; }

extern "C" int64_t smj_radix_smem_bytes(int64_t tile, int digit_bits) {
  return smem_bytes(tile, digit_bits);
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
  const int64_t smem = smem_bytes(tile, digit_bits);
  if (smem > SMJ_RADIX_MAX_SMEM) return (int)cudaErrorInvalidValue;
  RadixOps a;
  for (int op = 0; op < nops; ++op) {
    a.src[op] = static_cast<const int32_t*>(srcs[op]);
    a.dst[op] = static_cast<int32_t*>(dsts[op]);
  }
  a.nops = nops;
  cudaError_t err = cudaFuncSetAttribute(
      radix_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return (int)cudaSuccess;
  radix_tile_kernel<<<(unsigned)(n / tile), SMJ_RADIX_THREADS, (size_t)smem,
                      (cudaStream_t)stream>>>(a, tile, digit_bits, npass);
  return (int)cudaGetLastError();
}
