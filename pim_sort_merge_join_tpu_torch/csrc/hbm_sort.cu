// Stable sort by key for the PyTorch port: chunk sort, merge passes, gather.
//
// Replaces the TPU kernels of pim_sort_merge_join_tpu/ops/pallas/hbm_sort.py:
//   phase A  _chunk_sort_kernel (bitonic sort of each VMEM chunk)
//            -> chunk_sort_kernel below;
//   phase B  _merge_path_meta + _merge_kernel (merge-path co-partitioned
//            merge of adjacent runs) -> merge_partition_kernel + merge_kernel;
//   payload  planes that rode every pass on the TPU -> gather_kernel, once.
//
// The element is a (uint64 key, uint32 index) pair compared
// lexicographically. The index is the element's input position: it makes
// the sort stable and every element unique, as the TPU's synthetic arange
// plane did, so a merge never meets a tie. Signed keys are biased to the
// unsigned order here (x ^ sign bit); two int32 keys pack into one uint64.
// The last chunk is padded with key UINT64_MAX and indices >= n, which sort
// after every real element, sentinel keys included.
//
// What bounds it on an H100: device-memory traffic. Each merge pass reads
// and writes 12 bytes per element, and there are ceil(log2(n / CHUNK))
// passes. The design keeps every pass a streaming read and write: a CTA
// stages its two input windows in shared memory and merges them there
// (each element's output slot is its rank in its own window plus a binary
// search in the other), so global memory sees only coalesced copies. The
// merge-path split of each output tile is found once per pass by a
// separate partition kernel, one thread per tile, so no CTA waits on a
// dependent chain of global reads. The chunk sort is a shared-memory
// bitonic network; gathers of the payload columns read at random once.
// Later work: wider runs per pass, TMA staging, fewer passes.

#include <cstdint>
#include <cuda_runtime.h>

#define SMJ_CHUNK 2048
#define SMJ_CHUNK_THREADS 1024
#define SMJ_TILE 2048
#define SMJ_MERGE_THREADS 512
#define SMJ_PARTITION_THREADS 256
#define SMJ_GATHER_THREADS 256
#define SMJ_GATHER_MAX_COLS 8

namespace {

enum KeyKind { KIND_I32 = 0, KIND_I64 = 1, KIND_I32_PAIR = 2 };

__device__ __forceinline__ uint64_t load_key(const void* k0, const void* k1, int kind,
                                             int64_t g) {
  if (kind == KIND_I32) {
    return (uint64_t)((uint32_t)(static_cast<const int32_t*>(k0)[g]) ^ 0x80000000u);
  }
  if (kind == KIND_I64) {
    return (uint64_t)(static_cast<const int64_t*>(k0)[g]) ^ 0x8000000000000000ull;
  }
  const uint64_t hi = (uint32_t)(static_cast<const int32_t*>(k0)[g]) ^ 0x80000000u;
  const uint64_t lo = (uint32_t)(static_cast<const int32_t*>(k1)[g]) ^ 0x80000000u;
  return (hi << 32) | lo;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ bool elem_less(uint64_t ka, uint32_t ia, uint64_t kb, uint32_t ib) {
  return ka < kb || (ka == kb && ia < ib);
}

// Phase A: one CTA sorts one CHUNK-element run with a bitonic network.
__global__ void __launch_bounds__(SMJ_CHUNK_THREADS)
chunk_sort_kernel(const void* k0, const void* k1, int kind, int64_t n, uint64_t* out_keys,
                  uint32_t* out_idx) {
  __shared__ uint64_t sk[SMJ_CHUNK];
  __shared__ uint32_t si[SMJ_CHUNK];
  const int64_t base = (int64_t)blockIdx.x * SMJ_CHUNK;
  for (int t = threadIdx.x; t < SMJ_CHUNK; t += blockDim.x) {
    const int64_t g = base + t;
    sk[t] = g < n ? load_key(k0, k1, kind, g) : ~0ull;
    si[t] = (uint32_t)g;
  }
  __syncthreads();
  for (int k = 2; k <= SMJ_CHUNK; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < SMJ_CHUNK / 2; t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int p = i + j;
        const bool up = (i & k) == 0;
        const uint64_t ka = sk[i], kb = sk[p];
        const uint32_t ia = si[i], ib = si[p];
        if (elem_less(kb, ib, ka, ia) == up) {
          sk[i] = kb;
          sk[p] = ka;
          si[i] = ib;
          si[p] = ia;
        }
      }
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < SMJ_CHUNK; t += blockDim.x) {
    out_keys[base + t] = sk[t];
    out_idx[base + t] = si[t];
  }
}

// The pair of runs that output position o of a pass falls in: A starts at
// s with la elements, B follows it with lb (0 for a lone last run).
__device__ __forceinline__ void pair_bounds(int64_t o, int64_t npad, int64_t run, int64_t& s,
                                            int64_t& la, int64_t& lb) {
  s = (o / (2 * run)) * (2 * run);
  la = min64(run, npad - s);
  lb = max64(0, min64(run, npad - s - run));
}

// Phase B, step 1: merge-path split of every output tile. a_start[t] is the
// number of A elements among the first d outputs of tile t's pair, where d
// is the tile's first output position within the pair.
__global__ void merge_partition_kernel(const uint64_t* keys, const uint32_t* idx, int64_t npad,
                                       int64_t run, int32_t* a_start) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= npad / SMJ_TILE) return;
  int64_t s, la, lb;
  const int64_t o = t * SMJ_TILE;
  pair_bounds(o, npad, run, s, la, lb);
  const int64_t d = o - s;
  const uint64_t* ak = keys + s;
  const uint32_t* ai = idx + s;
  const uint64_t* bk = keys + s + la;
  const uint32_t* bi = idx + s + la;
  int64_t lo = max64(0, d - lb), hi = min64(d, la);
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    const int64_t j = d - 1 - mid;
    if (elem_less(ak[mid], ai[mid], bk[j], bi[j])) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  a_start[t] = (int32_t)lo;
}

// Phase B, step 2: one CTA writes one TILE of the merged output. Its A and
// B windows are staged in shared memory; each element's slot is its index
// in its own window plus the count of smaller elements in the other.
__global__ void __launch_bounds__(SMJ_MERGE_THREADS)
merge_kernel(const uint64_t* keys, const uint32_t* idx, uint64_t* out_keys, uint32_t* out_idx,
             const int32_t* a_start, int64_t npad, int64_t run) {
  __shared__ uint64_t sk[SMJ_TILE];
  __shared__ uint32_t si[SMJ_TILE];
  const int64_t t = blockIdx.x;
  const int64_t o = t * SMJ_TILE;
  int64_t s, la, lb;
  pair_bounds(o, npad, run, s, la, lb);
  const int64_t d = o - s;
  const int64_t a0 = a_start[t];
  const int64_t a1 = (d + SMJ_TILE >= la + lb) ? la : (int64_t)a_start[t + 1];
  const int na = (int)(a1 - a0);
  const int64_t b0 = d - a0;
  for (int e = threadIdx.x; e < SMJ_TILE; e += blockDim.x) {
    const int64_t g = e < na ? s + a0 + e : s + la + b0 + (e - na);
    sk[e] = keys[g];
    si[e] = idx[g];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < SMJ_TILE; e += blockDim.x) {
    const uint64_t k = sk[e];
    const uint32_t i = si[e];
    // Search the other window: B = [na, TILE) for an A element, A = [0, na)
    // for a B element.
    int lo = e < na ? na : 0;
    int hi = e < na ? SMJ_TILE : na;
    const int own = e < na ? e : e - na;
    const int other0 = lo;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (elem_less(sk[mid], si[mid], k, i)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t slot = o + own + (lo - other0);
    out_keys[slot] = k;
    out_idx[slot] = i;
  }
}

struct GatherArgs {
  const void* src[SMJ_GATHER_MAX_COLS];
  void* dst[SMJ_GATHER_MAX_COLS];
  int size[SMJ_GATHER_MAX_COLS];
  int ncols;
};

// out[c][i] = in[c][perm[i]] for every column c (int32 or int64).
__global__ void gather_kernel(GatherArgs a, const uint32_t* perm, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int64_t j = perm[i];
    for (int c = 0; c < a.ncols; ++c) {
      if (a.size[c] == 8) {
        static_cast<int64_t*>(a.dst[c])[i] = static_cast<const int64_t*>(a.src[c])[j];
      } else {
        static_cast<int32_t*>(a.dst[c])[i] = static_cast<const int32_t*>(a.src[c])[j];
      }
    }
  }
}

}  // namespace

extern "C" int smj_hbm_sort_chunk_size() { return SMJ_CHUNK; }

extern "C" int smj_hbm_sort_tile_size() { return SMJ_TILE; }

// Sorts each CHUNK of keys; out_keys/out_idx hold ceil(n / CHUNK) * CHUNK.
extern "C" int smj_chunk_sort(const void* k0, const void* k1, int kind, int64_t n,
                              void* out_keys, void* out_idx, void* stream) {
  const int64_t nchunks = (n + SMJ_CHUNK - 1) / SMJ_CHUNK;
  chunk_sort_kernel<<<(unsigned)nchunks, SMJ_CHUNK_THREADS, 0, (cudaStream_t)stream>>>(
      k0, k1, kind, n, static_cast<uint64_t*>(out_keys), static_cast<uint32_t*>(out_idx));
  return (int)cudaGetLastError();
}

// Merges adjacent sorted runs of length `run` from (keys, idx) into
// (out_keys, out_idx); a_start is scratch of npad / TILE int32.
extern "C" int smj_merge_pass(const void* keys, const void* idx, void* out_keys, void* out_idx,
                              void* a_start, int64_t npad, int64_t run, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int64_t ntiles = npad / SMJ_TILE;
  const int64_t pblocks = (ntiles + SMJ_PARTITION_THREADS - 1) / SMJ_PARTITION_THREADS;
  merge_partition_kernel<<<(unsigned)pblocks, SMJ_PARTITION_THREADS, 0, st>>>(
      static_cast<const uint64_t*>(keys), static_cast<const uint32_t*>(idx), npad, run,
      static_cast<int32_t*>(a_start));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)ntiles, SMJ_MERGE_THREADS, 0, st>>>(
      static_cast<const uint64_t*>(keys), static_cast<const uint32_t*>(idx),
      static_cast<uint64_t*>(out_keys), static_cast<uint32_t*>(out_idx),
      static_cast<const int32_t*>(a_start), npad, run);
  return (int)cudaGetLastError();
}

// Applies the permutation to up to SMJ_GATHER_MAX_COLS columns.
extern "C" int smj_gather(const void* const* srcs, void* const* dsts, const int* sizes,
                          int ncols, const void* perm, int64_t n, void* stream) {
  if (ncols < 1 || ncols > SMJ_GATHER_MAX_COLS) return (int)cudaErrorInvalidValue;
  GatherArgs a;
  for (int c = 0; c < ncols; ++c) {
    a.src[c] = srcs[c];
    a.dst[c] = dsts[c];
    a.size[c] = sizes[c];
  }
  a.ncols = ncols;
  int64_t blocks = (n + SMJ_GATHER_THREADS - 1) / SMJ_GATHER_THREADS;
  if (blocks > (1 << 16)) blocks = 1 << 16;
  if (blocks < 1) blocks = 1;
  gather_kernel<<<(unsigned)blocks, SMJ_GATHER_THREADS, 0, (cudaStream_t)stream>>>(
      a, static_cast<const uint32_t*>(perm), n);
  return (int)cudaGetLastError();
}
