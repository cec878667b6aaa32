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
// for the whole network; a block here holds at most 227 KB of shared memory
// (about 28k pairs), so the network cannot stay on chip. The classic GPU
// split does the work in two kernels:
//   - bitonic_local_kernel: one block per TILE pairs in shared memory runs
//     every substep with j < TILE. With k == 0 that is all of stages
//     k = 2..TILE (a tile's whole sort); with k > TILE it is the tail of
//     stage k. Device memory is read and written once per launch.
//   - bitonic_global_kernel: one compare-exchange substep with j >= TILE
//     over device memory, one thread per pair.
// At n = 2^21 and TILE = 2^12 that is 45 global substeps, each a streaming
// read and write of 16 MB, plus 10 local launches: device-memory traffic
// bounds it. The direction bit always comes from the global index, so a
// tile inside a stage k > TILE sorts in its half's direction.
// Later work: fuse several global substeps per pass through shared memory.

#include <cstdint>
#include <cuda_runtime.h>

#define SMJ_BITONIC_TILE 4096
#define SMJ_BITONIC_LOCAL_THREADS 1024
#define SMJ_BITONIC_GLOBAL_THREADS 256

namespace {

// Whether (ka, va) sorts after (kb, vb).
__device__ __forceinline__ bool pair_greater(int32_t ka, int32_t va, int32_t kb, int32_t vb) {
  return ka > kb || (ka == kb && va > vb);
}

// The pair index t's lower element for substep j: bit j of it is 0.
__device__ __forceinline__ uint32_t lower_of(uint32_t t, uint32_t j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

// Substeps j < tile of stage k (k == 0: all stages k = 2..tile) on one tile
// of `tile` pairs held in shared memory.
__global__ void __launch_bounds__(SMJ_BITONIC_LOCAL_THREADS)
bitonic_local_kernel(int32_t* keys, int32_t* vals, uint32_t tile, uint32_t k) {
  __shared__ int32_t sk[SMJ_BITONIC_TILE];
  __shared__ int32_t sv[SMJ_BITONIC_TILE];
  const uint32_t base = blockIdx.x * tile;
  for (uint32_t e = threadIdx.x; e < tile; e += blockDim.x) {
    sk[e] = keys[base + e];
    sv[e] = vals[base + e];
  }
  __syncthreads();
  const uint32_t k_first = k == 0 ? 2 : k;
  const uint32_t k_last = k == 0 ? tile : k;
  for (uint32_t kk = k_first; kk <= k_last; kk <<= 1) {
    for (uint32_t j = (kk < tile ? kk : tile) >> 1; j > 0; j >>= 1) {
      for (uint32_t t = threadIdx.x; t < tile / 2; t += blockDim.x) {
        const uint32_t i = lower_of(t, j);
        const uint32_t p = i + j;
        const bool up = ((base + i) & kk) == 0;
        const int32_t ka = sk[i], kb = sk[p], va = sv[i], vb = sv[p];
        if (pair_greater(ka, va, kb, vb) == up) {
          sk[i] = kb;
          sk[p] = ka;
          sv[i] = vb;
          sv[p] = va;
        }
      }
      __syncthreads();
    }
  }
  for (uint32_t e = threadIdx.x; e < tile; e += blockDim.x) {
    keys[base + e] = sk[e];
    vals[base + e] = sv[e];
  }
}

// One substep (k, j) over device memory; one thread per pair.
__global__ void bitonic_global_kernel(int32_t* keys, int32_t* vals, uint32_t n, uint32_t k,
                                      uint32_t j) {
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n / 2) return;
  const uint32_t i = lower_of(t, j);
  const uint32_t p = i + j;
  const bool up = (i & k) == 0;
  const int32_t ka = keys[i], kb = keys[p], va = vals[i], vb = vals[p];
  if (pair_greater(ka, va, kb, vb) == up) {
    keys[i] = kb;
    keys[p] = ka;
    vals[i] = vb;
    vals[p] = va;
  }
}

}  // namespace

extern "C" int smj_bitonic_tile_size() { return SMJ_BITONIC_TILE; }

// Runs bitonic_local_kernel over n pairs in place (n a multiple of tile,
// tile a power of two in [2, SMJ_BITONIC_TILE]).
extern "C" int smj_bitonic_local(void* keys, void* vals, int64_t n, int tile, int64_t k,
                                 void* stream) {
  if (tile < 2 || tile > SMJ_BITONIC_TILE || (tile & (tile - 1)) != 0 || n % tile != 0) {
    return (int)cudaErrorInvalidValue;
  }
  bitonic_local_kernel<<<(unsigned)(n / tile), SMJ_BITONIC_LOCAL_THREADS, 0,
                         (cudaStream_t)stream>>>(
      static_cast<int32_t*>(keys), static_cast<int32_t*>(vals), (uint32_t)tile, (uint32_t)k);
  return (int)cudaGetLastError();
}

// Runs one global substep (k, j) over n pairs in place.
extern "C" int smj_bitonic_global(void* keys, void* vals, int64_t n, int64_t k, int64_t j,
                                  void* stream) {
  const int64_t blocks = (n / 2 + SMJ_BITONIC_GLOBAL_THREADS - 1) / SMJ_BITONIC_GLOBAL_THREADS;
  bitonic_global_kernel<<<(unsigned)blocks, SMJ_BITONIC_GLOBAL_THREADS, 0,
                          (cudaStream_t)stream>>>(
      static_cast<int32_t*>(keys), static_cast<int32_t*>(vals), (uint32_t)n, (uint32_t)k,
      (uint32_t)j);
  return (int)cudaGetLastError();
}
