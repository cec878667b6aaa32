// Stable sort by key for the PyTorch port: run sort, merge passes, gather.
//
// Replaces the TPU kernels of pim_sort_merge_join_tpu/ops/pallas/hbm_sort.py:
//   phase A  _chunk_sort_kernel (bitonic sort of each VMEM chunk)
//            -> run_sort_kernel below;
//   phase B  _merge_path_meta + _merge_kernel (merge-path co-partitioned
//            merge of adjacent runs) -> merge_kernel, which finds its own
//            split;
//   payload  planes that rode every pass on the TPU -> gather_kernel, once.
//
// It is a merge sort, as on the TPU: sorted runs of RUN elements formed on
// chip, then pairwise merges of runs until one is left.
//
// The element. The wrapper picks one of three per sort (ops/kernels/
// hbm_sort.py, element_kind); signed keys are biased to unsigned order
// (x ^ sign bit):
//   packed-32  one uint64: the int32 key in the high half, the element's
//              input position in the low half. The position makes the sort
//              stable and every element unique.
//   pair-32    one uint64: two int32 keys and no other operand. No index:
//              elements that tie are equal in every operand, so their order
//              cannot be seen.
//   wide       (uint64 key, uint32 position), compared lexicographically:
//              an int64 key, or two int32 keys with payloads.
// The kernels are templates on whether the element is wide. Padding up to a
// multiple of RUN is UINT64_MAX (wide: with positions >= n), which no real
// element exceeds; the last pass writes only the first n outputs.
//
// What bounds it on an H100: device-memory traffic in phase B, one read and
// one write of every element per pass and ceil(log2(n / RUN)) passes, so
// the design spends its effort on bytes per element and on the number of
// passes.
//   - An 8-byte element moves a third less than a (key, index) pair and
//     compares as one integer.
//   - Runs of RUN = 8192 come from one block, so a 20M sort takes 12 passes:
//     each thread sorts 16 elements in registers with a fixed network, then
//     the block merges neighbouring runs through shared memory, each thread
//     finding its diagonal with one binary search and merging its 16
//     outputs serially, one compare each. By bytes phase A could run at the
//     memory rate; what it spends is those nine shared-memory rounds.
//   - A merge pass is the same step on device memory. A block finds the
//     merge-path split of its TILE outputs itself (two warps, each a 32-way
//     search: about five dependent loads where a binary search takes
//     twenty-four, and no partition launch), stages both windows in shared
//     memory with coalesced loads, all started before the first is used,
//     merges serially per thread, and sends the tile back through shared
//     memory so that the stores are coalesced. One pass then runs near the
//     memory rate; the passes' number is what is left to cut (a wider
//     fan-in needs a multi-way split).
//   - The last pass unpacks: it writes the sorted int32 key(s) and the
//     permutation, so a pair-32 sort needs no gather and a packed-32 sort
//     gathers only its payloads.
//   - Shared-memory slots are padded by one per 16, which keeps a thread's
//     16 consecutive elements off its neighbours' banks.
// The gather of operands that share no row reads at random once, one
// column per launch (gather_kernel below); a table's rows go through
// csrc/gather.cu. Times at the paths' shapes are in PERF.md.

#include <cstdint>
#include <cuda_runtime.h>

// Elements per thread, and the threads of a run-sort and of a merge block;
// RUN and TILE follow. Compile-time constants: ops/kernels/hbm_sort.py
// plans with the same two numbers and refuses a library that differs.
#define SMJ_ITEMS 16
#define SMJ_RUN_THREADS 512
#define SMJ_TILE_THREADS 256
#define SMJ_RUN_BLOCKS_PER_SM 2
#define SMJ_TILE_BLOCKS_PER_SM 4
#define SMJ_RUN (SMJ_RUN_THREADS * SMJ_ITEMS)
#define SMJ_TILE (SMJ_TILE_THREADS * SMJ_ITEMS)
#define SMJ_GATHER_THREADS 256

namespace {

enum ElementKind { KIND_PACKED32 = 0, KIND_PAIR32 = 1, KIND_WIDE_I64 = 2, KIND_WIDE_PAIR = 3 };

constexpr uint32_t BIAS32 = 0x80000000u;
constexpr uint64_t BIAS64 = 0x8000000000000000ull;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// `i` is the position of a wide element and a constant 0 otherwise, so that
// every use of it folds away.
struct Elem {
  uint64_t k;
  uint32_t i;
};

template <bool WIDE>
__device__ __forceinline__ bool less(const Elem& a, const Elem& b) {
  if constexpr (WIDE) {
    return a.k < b.k || (a.k == b.k && a.i < b.i);
  } else {
    return a.k < b.k;
  }
}

template <bool WIDE>
__device__ __forceinline__ Elem load_global(const uint64_t* keys, const uint32_t* idx, int64_t g) {
  Elem e;
  e.k = keys[g];
  if constexpr (WIDE) {
    e.i = idx[g];
  } else {
    e.i = 0;
  }
  return e;
}

template <int KIND>
__device__ __forceinline__ Elem load_operands(const void* k0, const void* k1, int64_t g) {
  Elem e;
  e.i = KIND >= KIND_WIDE_I64 ? (uint32_t)g : 0u;
  if constexpr (KIND == KIND_WIDE_I64) {
    e.k = (uint64_t)(static_cast<const int64_t*>(k0)[g]) ^ BIAS64;
  } else {
    const uint64_t hi = (uint32_t)(static_cast<const int32_t*>(k0)[g]) ^ BIAS32;
    uint64_t lo = (uint32_t)g;
    if constexpr (KIND != KIND_PACKED32) {
      lo = (uint32_t)(static_cast<const int32_t*>(k1)[g]) ^ BIAS32;
    }
    e.k = (hi << 32) | lo;
  }
  return e;
}

// A block's elements in shared memory: logical slot j lives at j + j / 16.
__host__ __device__ constexpr int padded_slots(int n) { return n + n / SMJ_ITEMS + 2; }

constexpr size_t shared_bytes(int n, bool wide) {
  return (size_t)padded_slots(n) * (wide ? 12 : 8);
}

template <bool WIDE>
struct Shared {
  uint64_t* k;
  uint32_t* i;

  __device__ __forceinline__ explicit Shared(int n) {
    extern __shared__ __align__(16) uint64_t smj_shared[];
    k = smj_shared;
    i = reinterpret_cast<uint32_t*>(smj_shared + padded_slots(n));
  }

  __device__ __forceinline__ Elem get(int j) const {
    const int p = j + j / SMJ_ITEMS;
    Elem e;
    e.k = k[p];
    if constexpr (WIDE) {
      e.i = i[p];
    } else {
      e.i = 0;
    }
    return e;
  }

  __device__ __forceinline__ void put(int j, const Elem& e) const {
    const int p = j + j / SMJ_ITEMS;
    k[p] = e.k;
    if constexpr (WIDE) i[p] = e.i;
  }
};

// Bitonic network over a thread's 16 registers; every index is a constant
// after unrolling.
template <bool WIDE>
__device__ __forceinline__ void sort_registers(Elem (&r)[SMJ_ITEMS]) {
#pragma unroll
  for (int k = 2; k <= SMJ_ITEMS; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < SMJ_ITEMS; ++i) {
        const int l = i ^ j;
        if (l > i) {
          const bool up = (i & k) == 0;
          const Elem x = r[i], y = r[l];
          const bool swap = up ? less<WIDE>(y, x) : less<WIDE>(x, y);
          r[i] = swap ? y : x;
          r[l] = swap ? x : y;
        }
      }
    }
  }
}

// Merge path over two sorted windows in shared memory, A = [a0, a0 + la) and
// B = [b0, b0 + lb): how many of the first d merged outputs come from A.
// A wins ties.
template <bool WIDE>
__device__ __forceinline__ int merge_path(const Shared<WIDE>& s, int a0, int la, int b0, int lb,
                                          int d) {
  int lo = max(0, d - lb), hi = min(d, la);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (!less<WIDE>(s.get(b0 + d - 1 - mid), s.get(a0 + mid))) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The next 16 outputs of the merge of [a, a_end) and [b, b_end), one compare
// each. It reads one slot past a window's end, which the padding provides.
template <bool WIDE>
__device__ __forceinline__ void serial_merge(const Shared<WIDE>& s, int a, int a_end, int b,
                                             int b_end, Elem (&r)[SMJ_ITEMS]) {
  Elem ea = s.get(a), eb = s.get(b);
#pragma unroll
  for (int i = 0; i < SMJ_ITEMS; ++i) {
    const bool take_a = b >= b_end || (a < a_end && !less<WIDE>(eb, ea));
    r[i] = take_a ? ea : eb;
    if (take_a) {
      ea = s.get(++a);
    } else {
      eb = s.get(++b);
    }
  }
}

template <bool WIDE>
__device__ __forceinline__ void put_blocked(const Shared<WIDE>& s, const Elem (&r)[SMJ_ITEMS]) {
#pragma unroll
  for (int i = 0; i < SMJ_ITEMS; ++i) s.put(threadIdx.x * SMJ_ITEMS + i, r[i]);
}

// Phase A: one block sorts one run of RUN elements.
template <int KIND>
__global__ void __launch_bounds__(SMJ_RUN_THREADS, KIND >= KIND_WIDE_I64 ? 1 : SMJ_RUN_BLOCKS_PER_SM)
run_sort_kernel(const void* __restrict__ k0, const void* __restrict__ k1, int64_t n,
                uint64_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx) {
  constexpr bool WIDE = KIND >= KIND_WIDE_I64;
  const Shared<WIDE> s(SMJ_RUN);
  const int64_t base = (int64_t)blockIdx.x * SMJ_RUN;
  for (int j = threadIdx.x; j < SMJ_RUN; j += SMJ_RUN_THREADS) {
    const int64_t g = base + j;
    Elem e;
    if (g < n) {
      e = load_operands<KIND>(k0, k1, g);
    } else {
      e.k = ~0ull;
      e.i = WIDE ? (uint32_t)g : 0u;
    }
    s.put(j, e);
  }
  __syncthreads();
  Elem r[SMJ_ITEMS];
  const int first = threadIdx.x * SMJ_ITEMS;
#pragma unroll
  for (int i = 0; i < SMJ_ITEMS; ++i) r[i] = s.get(first + i);
  sort_registers<WIDE>(r);
  for (int len = SMJ_ITEMS; len < SMJ_RUN; len <<= 1) {
    __syncthreads();
    put_blocked<WIDE>(s, r);
    __syncthreads();
    const int start = first & ~(2 * len - 1);
    const int d = first - start;
    const int a = merge_path<WIDE>(s, start, len, start + len, len, d);
    serial_merge<WIDE>(s, start + a, start + len, start + len + d - a, start + 2 * len, r);
  }
  __syncthreads();
  put_blocked<WIDE>(s, r);
  __syncthreads();
  for (int j = threadIdx.x; j < SMJ_RUN; j += SMJ_RUN_THREADS) {
    const Elem e = s.get(j);
    out_keys[base + j] = e.k;
    if constexpr (WIDE) out_idx[base + j] = e.i;
  }
}

// Merge path over two sorted runs in device memory by one warp: each step
// probes 32 points of the remaining range at once. Every lane returns the
// count of A elements among the first d merged outputs.
template <bool WIDE>
__device__ __forceinline__ int64_t warp_merge_path(const uint64_t* ak, const uint32_t* ai,
                                                   const uint64_t* bk, const uint32_t* bi,
                                                   int64_t la, int64_t lb, int64_t d, int lane) {
  int64_t lo = max64(0, d - lb), hi = min64(d, la);
  while (lo < hi) {
    const int64_t chunk = (hi - lo + 31) / 32;
    const int64_t mine = lo + lane * chunk;
    const int64_t i = min64(mine + chunk - 1, hi - 1);
    bool a_first = false;
    if (mine < hi) {
      a_first = !less<WIDE>(load_global<WIDE>(bk, bi, d - 1 - i), load_global<WIDE>(ak, ai, i));
    }
    // The probes are in order and the test is monotone: true for a prefix
    // of the lanes.
    const int c = __popc(__ballot_sync(0xffffffffu, a_first));
    const int64_t next = lo + c * chunk;  // first index of lane c's range
    const int64_t new_lo = c > 0 ? min64(next - 1, hi - 1) + 1 : lo;
    if (c < 32 && next < hi) hi = min64(next + chunk - 1, hi - 1);
    lo = new_lo;
  }
  return lo;
}

// The pair of runs that output position o of a pass falls in: A starts at
// s with la elements, B follows it with lb (0 for a lone last run).
__device__ __forceinline__ void pair_bounds(int64_t o, int64_t npad, int64_t run, int64_t& s,
                                            int64_t& la, int64_t& lb) {
  s = (o / (2 * run)) * (2 * run);
  la = min64(run, npad - s);
  lb = max64(0, min64(run, npad - s - run));
}

// Phase B: one block writes one TILE of a pass's merged output. A last pass
// (FINAL) writes the first n outputs unpacked: a wide element's position to
// out1; an 8-byte element's high half as the int32 key to out0 and its low
// half to out1, as a position (lo_bias 0) or a second int32 key (BIAS32).
template <bool WIDE, bool FINAL>
__global__ void __launch_bounds__(SMJ_TILE_THREADS, WIDE ? SMJ_TILE_BLOCKS_PER_SM / 2 : SMJ_TILE_BLOCKS_PER_SM)
merge_kernel(const uint64_t* __restrict__ keys, const uint32_t* __restrict__ idx,
             uint64_t* __restrict__ out_keys, uint32_t* __restrict__ out_idx, int64_t npad,
             int64_t run, int64_t n, int32_t* __restrict__ out0, uint32_t* __restrict__ out1,
             uint32_t lo_bias) {
  const Shared<WIDE> s(SMJ_TILE);
  __shared__ int64_t split[2];
  const int tid = threadIdx.x;
  const int64_t o = (int64_t)blockIdx.x * SMJ_TILE;
  int64_t s0, la, lb;
  pair_bounds(o, npad, run, s0, la, lb);
  const int64_t d = o - s0;
  const uint64_t* ak = keys + s0;
  const uint64_t* bk = ak + la;
  const uint32_t* ai = WIDE ? idx + s0 : nullptr;
  const uint32_t* bi = WIDE ? ai + la : nullptr;
  if (tid < 64) {
    const int warp = tid >> 5, lane = tid & 31;
    const int64_t a = warp_merge_path<WIDE>(ak, ai, bk, bi, la, lb, d + warp * SMJ_TILE, lane);
    if (lane == 0) split[warp] = a;
  }
  __syncthreads();
  const int64_t a0 = split[0];
  const int na = (int)(split[1] - a0);
  const int64_t b0 = d - a0;

  // Stage the A window in slots [0, na) and the B window after it.
  Elem r[SMJ_ITEMS];
#pragma unroll
  for (int i = 0; i < SMJ_ITEMS; ++i) {
    const int j = tid + i * SMJ_TILE_THREADS;
    r[i] = j < na ? load_global<WIDE>(ak, ai, a0 + j) : load_global<WIDE>(bk, bi, b0 + (j - na));
  }
#pragma unroll
  for (int i = 0; i < SMJ_ITEMS; ++i) s.put(tid + i * SMJ_TILE_THREADS, r[i]);
  __syncthreads();

  const int dt = tid * SMJ_ITEMS;
  const int a = merge_path<WIDE>(s, 0, na, na, SMJ_TILE - na, dt);
  serial_merge<WIDE>(s, a, na, na + dt - a, SMJ_TILE, r);
  __syncthreads();
  put_blocked<WIDE>(s, r);
  __syncthreads();

#pragma unroll
  for (int i = 0; i < SMJ_ITEMS; ++i) {
    const int j = tid + i * SMJ_TILE_THREADS;
    const Elem e = s.get(j);
    const int64_t g = o + j;
    if constexpr (!FINAL) {
      out_keys[g] = e.k;
      if constexpr (WIDE) out_idx[g] = e.i;
    } else if (g < n) {
      if constexpr (WIDE) {
        out1[g] = e.i;
      } else {
        out0[g] = (int32_t)((uint32_t)(e.k >> 32) ^ BIAS32);
        out1[g] = (uint32_t)e.k ^ lo_bias;
      }
    }
  }
}

// Four values of T moved by the widest access their size allows, 16 bytes
// at most.
template <typename T>
struct alignas(sizeof(T) * 4 < 16 ? sizeof(T) * 4 : 16) Vec4 {
  T v[4];
};

// out[i] = in[perm[i]] for one column, an operand that shares no row with
// the others. What bounds it is the rate of random 32-byte sectors, one per
// value read, and that rate falls when one launch reads several arrays at
// random at once: on an H100, at 20M x 3 int32, one launch for all three
// columns takes 1.92 ms and three launches 1.56 (PERF.md). So a launch moves
// one column.
// A thread takes four consecutive outputs: one vector load brings their
// indices, the four random reads start before the store, and the values
// leave in one vector store. Against one output per thread that is the same
// time on a random permutation and 0.39 ms against 0.45 at 10M x 4 int32 on
// the join's own permutations, whose neighbours often share a sector
// (PERF.md). `vec` says that perm and out are 16-byte aligned; without it,
// and in the last partial group, the accesses are scalar and guarded.
template <typename T>
__global__ void __launch_bounds__(SMJ_GATHER_THREADS)
gather_kernel(const T* __restrict__ in, T* __restrict__ out, const uint32_t* __restrict__ perm,
              int64_t n, int vec) {
  const int64_t groups = (n + 3) / 4;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; g < groups; g += stride) {
    const int64_t i0 = g * 4;
    const int cnt = n - i0 < 4 ? (int)(n - i0) : 4;
    if (vec != 0 && cnt == 4) {
      const Vec4<uint32_t> j = *reinterpret_cast<const Vec4<uint32_t>*>(perm + i0);
      Vec4<T> v;
#pragma unroll
      for (int t = 0; t < 4; ++t) v.v[t] = in[j.v[t]];
      *reinterpret_cast<Vec4<T>*>(out + i0) = v;
    } else {
      for (int t = 0; t < cnt; ++t) out[i0 + t] = in[perm[i0 + t]];
    }
  }
}

template <int KIND>
cudaError_t launch_run_sort(const void* k0, const void* k1, int64_t n, void* out_keys,
                            void* out_idx, cudaStream_t st) {
  const size_t smem = shared_bytes(SMJ_RUN, KIND >= KIND_WIDE_I64);
  cudaError_t err = cudaFuncSetAttribute(
      run_sort_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int64_t nruns = (n + SMJ_RUN - 1) / SMJ_RUN;
  run_sort_kernel<KIND><<<(unsigned)nruns, SMJ_RUN_THREADS, smem, st>>>(
      k0, k1, n, static_cast<uint64_t*>(out_keys), static_cast<uint32_t*>(out_idx));
  return cudaGetLastError();
}

template <bool WIDE, bool FINAL>
cudaError_t launch_merge(const void* keys, const void* idx, void* out_keys, void* out_idx,
                         int64_t npad, int64_t run, int64_t n, void* out0, void* out1,
                         uint32_t lo_bias, cudaStream_t st) {
  const size_t smem = shared_bytes(SMJ_TILE, WIDE);
  cudaError_t err = cudaFuncSetAttribute(
      merge_kernel<WIDE, FINAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  merge_kernel<WIDE, FINAL><<<(unsigned)(npad / SMJ_TILE), SMJ_TILE_THREADS, smem, st>>>(
      static_cast<const uint64_t*>(keys), static_cast<const uint32_t*>(idx),
      static_cast<uint64_t*>(out_keys), static_cast<uint32_t*>(out_idx), npad, run, n,
      static_cast<int32_t*>(out0), static_cast<uint32_t*>(out1), lo_bias);
  return cudaGetLastError();
}

bool bad_pass(int64_t npad, int64_t run) {
  return npad < SMJ_RUN || npad % SMJ_RUN != 0 || run < SMJ_RUN || run % SMJ_RUN != 0;
}

}  // namespace

extern "C" int smj_hbm_sort_run_size() { return SMJ_RUN; }

extern "C" int smj_hbm_sort_tile_size() { return SMJ_TILE; }

// Phase A. Builds the elements of `kind` from the key operand(s) and sorts
// every RUN of them; out_keys (and out_idx, for a wide kind) hold
// ceil(n / RUN) * RUN elements.
extern "C" int smj_chunk_sort(const void* k0, const void* k1, int kind, int64_t n,
                              void* out_keys, void* out_idx, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n < 1) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case KIND_PACKED32:
      return (int)launch_run_sort<KIND_PACKED32>(k0, k1, n, out_keys, out_idx, st);
    case KIND_PAIR32:
      return (int)launch_run_sort<KIND_PAIR32>(k0, k1, n, out_keys, out_idx, st);
    case KIND_WIDE_I64:
      return (int)launch_run_sort<KIND_WIDE_I64>(k0, k1, n, out_keys, out_idx, st);
    case KIND_WIDE_PAIR:
      return (int)launch_run_sort<KIND_WIDE_PAIR>(k0, k1, n, out_keys, out_idx, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Phase B, a pass that is not the last: merges adjacent sorted runs of
// length `run` (a multiple of RUN) from (keys, idx) into (out_keys,
// out_idx); the idx arrays are used only for wide elements.
extern "C" int smj_merge_pass(const void* keys, const void* idx, void* out_keys, void* out_idx,
                              int wide, int64_t npad, int64_t run, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bad_pass(npad, run)) return (int)cudaErrorInvalidValue;
  if (wide) {
    return (int)launch_merge<true, false>(keys, idx, out_keys, out_idx, npad, run, npad,
                                          nullptr, nullptr, 0, st);
  }
  return (int)launch_merge<false, false>(keys, nullptr, out_keys, nullptr, npad, run, npad,
                                         nullptr, nullptr, 0, st);
}

// Phase B, the last pass (2 * run >= npad): writes the first n outputs
// unpacked. Wide: out1 = positions (uint32). Otherwise out0 = the int32
// keys, out1 = positions, or the second int32 keys if low_is_key.
extern "C" int smj_merge_pass_final(const void* keys, const void* idx, int wide, int64_t npad,
                                    int64_t run, int64_t n, void* out0, void* out1,
                                    int low_is_key, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bad_pass(npad, run) || 2 * run < npad || n < 1 || n > npad) {
    return (int)cudaErrorInvalidValue;
  }
  if (wide) {
    return (int)launch_merge<true, true>(keys, idx, nullptr, nullptr, npad, run, n, nullptr,
                                         out1, 0, st);
  }
  return (int)launch_merge<false, true>(keys, nullptr, nullptr, nullptr, npad, run, n, out0,
                                        out1, low_is_key ? BIAS32 : 0u, st);
}

// out[i] = in[perm[i]] for i < n: one column of elem_bytes (4 or 8) per
// element, perm uint32.
extern "C" int smj_gather(const void* in, void* out, int elem_bytes, const void* perm, int64_t n,
                          void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 8) || n < 1) return (int)cudaErrorInvalidValue;
  const int vec = reinterpret_cast<uintptr_t>(perm) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  int64_t blocks = ((n + 3) / 4 + SMJ_GATHER_THREADS - 1) / SMJ_GATHER_THREADS;
  if (blocks > (1 << 16)) blocks = 1 << 16;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* p = static_cast<const uint32_t*>(perm);
  if (elem_bytes == 8) {
    gather_kernel<int64_t><<<(unsigned)blocks, SMJ_GATHER_THREADS, 0, st>>>(
        static_cast<const int64_t*>(in), static_cast<int64_t*>(out), p, n, vec);
  } else {
    gather_kernel<int32_t><<<(unsigned)blocks, SMJ_GATHER_THREADS, 0, st>>>(
        static_cast<const int32_t*>(in), static_cast<int32_t*>(out), p, n, vec);
  }
  return (int)cudaGetLastError();
}
