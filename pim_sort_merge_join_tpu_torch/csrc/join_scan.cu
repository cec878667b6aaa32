// The 1:1 join-rank scan for the PyTorch port: forward and backward passes.
//
// Replaces the TPU kernels of pim_sort_merge_join_tpu/ops/pallas/join_scan.py:
//   _forward_kernel  -> join_scan_forward_kernel
//   _backward_kernel -> join_scan_backward_kernel
// and computes exactly what ops/join._merged_dest_plain computes. Input: the
// merge sort's output, keys ascending with side-1 elements (mpos < cap1)
// before side-2 elements within each equal-key run. Forward: side-2 prefix
// count c2, run-head broadcasts run_start and base2, ranks, side-2 matches
// and their prefix m2cum; a matched side-2 element gets its slot m2cum - 1,
// a live side-1 element the complement of its candidate slot m2cum + rank,
// anything else the drop value n. Backward: the suffix minimum of the
// tail-gated m2cum is each run's total match count, which settles the
// side-1 candidates.
//
// The TPU ran the tiles in order and carried the scan state in SMEM. CUDA
// blocks run in no order, so the carry is a chain: each block takes a
// ticket (atomicAdd) in launch order, so every block it waits for is
// already resident, and thread 0 waits for its predecessor's published
// state, then publishes its own. The block computes everything it can
// before it waits, so the wait is followed by O(1) work: the state at its
// end (c2, base2, run_start, m2cum) follows from the carry in and a few
// block totals, because only the elements before the block's first run
// head depend on the carry, and within that partial run the side-1
// elements precede the side-2 ones, so its side-2 matches have a closed
// form. Keys for head and tail tests are read from the input itself.
//
// What bounds it on an H100: the chain. Each block hop costs a global
// write, fence and read (about a microsecond), so the time grows with
// n / JS_BLOCK; the arithmetic is a few block scans per pass. Traffic is
// 12-16 bytes per element in each pass. Later work: a decoupled look-back
// over an associative form of the run state, to take the chain off the
// critical path.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define JS_THREADS 512
#define JS_ITEMS 8
#define JS_BLOCK (JS_THREADS * JS_ITEMS)
#define JS_WARPS (JS_THREADS / 32)

namespace {

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Max {
  __device__ int operator()(int a, int b) const { return a > b ? a : b; }
};
struct Min {
  __device__ int operator()(int a, int b) const { return a < b ? a : b; }
};

template <typename KeyT>
__device__ __forceinline__ KeyT key_sentinel();
template <>
__device__ __forceinline__ int32_t key_sentinel<int32_t>() {
  return INT32_MAX;
}
template <>
__device__ __forceinline__ int64_t key_sentinel<int64_t>() {
  return INT64_MAX;
}

// Exclusive scan of one value per thread, in thread order; *total gets the
// combination over the whole block. Every thread of the block must call it.
template <typename Op>
__device__ int block_exclusive_scan(int v, int identity, Op op, int* total) {
  __shared__ int warp_tot[JS_WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = op(x, y);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < JS_WARPS ? warp_tot[lane] : identity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = op(w, y);
    }
    if (lane < JS_WARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  const int before_warp = warp > 0 ? warp_tot[warp - 1] : identity;
  int before_lane = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before_lane = identity;
  *total = warp_tot[JS_WARPS - 1];
  __syncthreads();  // warp_tot is reused by the next scan
  return op(before_warp, before_lane);
}

// Published carry record of block b: [flag, values...], 8 ints apart after
// an 8-int header whose first int is the ticket counter.
__device__ __forceinline__ volatile int* record(int32_t* state, int b) {
  return state + 8 + 8 * b;
}

__device__ __forceinline__ void wait_ready(const volatile int* rec) {
  while (rec[0] == 0) __nanosleep(32);
  __threadfence();
}

__device__ __forceinline__ void publish(volatile int* rec) {
  __threadfence();
  rec[0] = 1;
}

template <typename KeyT>
__global__ void __launch_bounds__(JS_THREADS)
join_scan_forward_kernel(const KeyT* keys, const int32_t* mpos, int64_t n, int cap1,
                         int32_t* cand, int32_t* m2out, int32_t* state) {
  __shared__ int s_ticket;
  __shared__ int s_carry[4];
  if (threadIdx.x == 0) s_ticket = atomicAdd(&state[0], 1);
  __syncthreads();
  const int b = s_ticket;
  const int64_t base = (int64_t)b * JS_BLOCK;
  const int t0 = threadIdx.x * JS_ITEMS;  // block-relative position of item 0
  const KeyT sent = key_sentinel<KeyT>();

  KeyT k[JS_ITEMS];
  int is2[JS_ITEMS];
  bool head[JS_ITEMS];
  bool valid[JS_ITEMS];
  {
    const int64_t i0 = base + t0;
    KeyT prev = (i0 > 0 && i0 - 1 < n) ? keys[i0 - 1] : sent;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      const int64_t i = i0 + q;
      valid[q] = i < n;
      k[q] = valid[q] ? keys[i] : sent;
      is2[q] = (valid[q] && mpos[i] >= cap1) ? 1 : 0;
      head[q] = valid[q] && (i == 0 || k[q] != prev);
      prev = k[q];
    }
  }

  // Block-relative side-2 count (inclusive) per item.
  int tsum = 0;
#pragma unroll
  for (int q = 0; q < JS_ITEMS; ++q) tsum += is2[q];
  int total2;
  const int c2off = block_exclusive_scan(tsum, 0, Sum(), &total2);
  int lc2[JS_ITEMS];
  int th_rs = -1, th_hb = -1;
  {
    int c = c2off;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      c += is2[q];
      lc2[q] = c;
      if (head[q]) {
        th_rs = t0 + q;
        th_hb = c - is2[q];
      }
    }
  }
  // Latest head at or before each item: its block position (rsl) and the
  // block-relative side-2 count before it (lb2); -1 before the first head.
  int last_rs, last_hb;
  const int rs_off = block_exclusive_scan(th_rs, -1, Max(), &last_rs);
  const int hb_off = block_exclusive_scan(th_hb, -1, Max(), &last_hb);
  int rsl[JS_ITEMS], lb2[JS_ITEMS];
  int pre1 = 0, pre2 = 0, rest_m = 0;
  {
    int r = rs_off, h = hb_off;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      if (head[q]) {
        r = t0 + q;
        h = lc2[q] - is2[q];
      }
      rsl[q] = r;
      lb2[q] = h;
      if (!valid[q]) continue;
      if (r < 0) {
        // Before the first head: the predecessor's run continues here.
        pre1 += 1 - is2[q];
        pre2 += is2[q];
      } else {
        const int jr = t0 + q - r;
        const int s2r = lc2[q] - h;
        const int rank = is2[q] ? s2r - 1 : jr;
        rest_m += (is2[q] && rank < jr + 1 - s2r && k[q] != sent) ? 1 : 0;
      }
    }
  }
  int a1, a2, mrest;
  block_exclusive_scan(pre1, 0, Sum(), &a1);
  block_exclusive_scan(pre2, 0, Sum(), &a2);
  block_exclusive_scan(rest_m, 0, Sum(), &mrest);

  if (threadIdx.x == 0) {
    int c2 = 0, base2 = 0, rs = 0, m2 = 0;
    if (b > 0) {
      const volatile int* prev = record(state, b - 1);
      wait_ready(prev);
      c2 = prev[1];
      base2 = prev[2];
      rs = prev[3];
      m2 = prev[4];
    }
    // The open run has n1b side-1 and n2b side-2 elements before this
    // block; its side-2 elements here (a2 of them) are matched while their
    // run rank stays below the run's side-1 total n1b + a1.
    const int n2b = c2 - base2;
    const int n1b = (int)(base - rs) - n2b;
    const int gap = n1b + a1 - n2b;
    const bool live_pre = k[0] != sent;  // thread 0 holds the block's first element
    const int pm = live_pre ? min(max(gap, 0), a2) : 0;
    volatile int* mine = record(state, b);
    mine[1] = c2 + total2;
    mine[2] = last_rs >= 0 ? c2 + last_hb : base2;
    mine[3] = last_rs >= 0 ? (int)base + last_rs : rs;
    mine[4] = m2 + pm + mrest;
    publish(mine);
    s_carry[0] = c2;
    s_carry[1] = base2;
    s_carry[2] = rs;
    s_carry[3] = m2;
  }
  __syncthreads();
  const int in_c2 = s_carry[0], in_base2 = s_carry[1], in_rs = s_carry[2], in_m2 = s_carry[3];

  int matched[JS_ITEMS], rank[JS_ITEMS];
  int msum = 0;
#pragma unroll
  for (int q = 0; q < JS_ITEMS; ++q) {
    const int i = (int)(base + t0 + q);
    const int c2 = in_c2 + lc2[q];
    const int rs = rsl[q] < 0 ? in_rs : (int)base + rsl[q];
    const int b2 = rsl[q] < 0 ? in_base2 : in_c2 + lb2[q];
    const int jr = i - rs;
    const int s2r = c2 - b2;
    rank[q] = is2[q] ? s2r - 1 : jr;
    matched[q] = (valid[q] && is2[q] && rank[q] < jr + 1 - s2r && k[q] != sent) ? 1 : 0;
    msum += matched[q];
  }
  int mtot;
  int m = in_m2 + block_exclusive_scan(msum, 0, Sum(), &mtot);
#pragma unroll
  for (int q = 0; q < JS_ITEMS; ++q) {
    if (!valid[q]) continue;
    const int64_t i = base + t0 + q;
    m += matched[q];
    int c = (int)n;
    if (matched[q]) {
      c = m - 1;
    } else if (!is2[q] && k[q] != sent) {
      c = ~(m + rank[q]);
    }
    cand[i] = c;
    m2out[i] = m;
  }
}

template <typename KeyT>
__global__ void __launch_bounds__(JS_THREADS)
join_scan_backward_kernel(const KeyT* keys, const int32_t* cand, const int32_t* m2, int64_t n,
                          int nblocks, int32_t* dest, int32_t* num_out, int32_t* state) {
  __shared__ int s_ticket;
  __shared__ int s_cin;
  if (threadIdx.x == 0) s_ticket = atomicAdd(&state[0], 1);
  __syncthreads();
  const int b = nblocks - 1 - s_ticket;  // tickets walk the blocks from the end
  const int64_t base = (int64_t)b * JS_BLOCK;
  // Thread t walks its items backward from block position JS_BLOCK-1-t*ITEMS.
  const int64_t i0 = base + JS_BLOCK - 1 - threadIdx.x * JS_ITEMS;

  // Running minimum of m2cum over run tails at or after each item.
  int sm[JS_ITEMS];
  int run_min = INT_MAX;
  {
    KeyT next = (i0 + 1 < n) ? keys[i0 + 1] : (KeyT)0;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      const int64_t i = i0 - q;
      const bool valid = i < n;
      const KeyT kk = valid ? keys[i] : (KeyT)0;
      if (valid && (i == n - 1 || kk != next)) run_min = min(run_min, (int)m2[i]);
      sm[q] = run_min;
      next = kk;
    }
  }
  int blk_min;
  const int after = block_exclusive_scan(run_min, INT_MAX, Min(), &blk_min);

  if (threadIdx.x == 0) {
    int cin = INT_MAX;
    if (b < nblocks - 1) {
      const volatile int* succ = record(state, b + 1);
      wait_ready(succ);
      cin = succ[1];
    }
    volatile int* mine = record(state, b);
    mine[1] = min(blk_min, cin);
    publish(mine);
    s_cin = cin;
  }
  __syncthreads();
  const int cin = min(after, s_cin);
#pragma unroll
  for (int q = 0; q < JS_ITEMS; ++q) {
    const int64_t i = i0 - q;
    if (i >= n) continue;
    const int end_m2 = min(sm[q], cin);
    const int c = cand[i];
    dest[i] = c < 0 ? (~c < end_m2 ? ~c : (int)n) : c;
    if (i == n - 1) *num_out = m2[i];
  }
}

}  // namespace

extern "C" int smj_join_scan_block_size() { return JS_BLOCK; }

// state: zeroed int32 [8 + 8 * nblocks].
extern "C" int smj_join_scan_forward(const void* keys, int key_bytes, const void* mpos,
                                     int64_t n, int cap1, void* cand, void* m2, void* state,
                                     void* stream) {
  const unsigned nblocks = (unsigned)((n + JS_BLOCK - 1) / JS_BLOCK);
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* mp = static_cast<const int32_t*>(mpos);
  int32_t* cd = static_cast<int32_t*>(cand);
  int32_t* mo = static_cast<int32_t*>(m2);
  int32_t* sp = static_cast<int32_t*>(state);
  if (key_bytes == 4) {
    join_scan_forward_kernel<int32_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int32_t*>(keys), mp, n, cap1, cd, mo, sp);
  } else if (key_bytes == 8) {
    join_scan_forward_kernel<int64_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int64_t*>(keys), mp, n, cap1, cd, mo, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// state: zeroed int32 [8 + 8 * nblocks], not the forward pass's.
extern "C" int smj_join_scan_backward(const void* keys, int key_bytes, const void* cand,
                                      const void* m2, int64_t n, void* dest, void* num_out,
                                      void* state, void* stream) {
  const int nblocks = (int)((n + JS_BLOCK - 1) / JS_BLOCK);
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* cd = static_cast<const int32_t*>(cand);
  const int32_t* mi = static_cast<const int32_t*>(m2);
  int32_t* de = static_cast<int32_t*>(dest);
  int32_t* no = static_cast<int32_t*>(num_out);
  int32_t* sp = static_cast<int32_t*>(state);
  if (key_bytes == 4) {
    join_scan_backward_kernel<int32_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int32_t*>(keys), cd, mi, n, nblocks, de, no, sp);
  } else if (key_bytes == 8) {
    join_scan_backward_kernel<int64_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int64_t*>(keys), cd, mi, n, nblocks, de, no, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
