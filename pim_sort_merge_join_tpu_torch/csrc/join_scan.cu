// The 1:1 join-rank scan for the PyTorch port: forward and backward passes,
// and the placement of each output slot's source rows.
//
// Replaces the TPU kernels of pim_sort_merge_join_tpu/ops/pallas/join_scan.py:
//   _forward_kernel  -> join_scan_forward_kernel
//   _backward_kernel -> join_scan_backward_kernel
// and, with join_scan_place_kernel (its note is above the kernel), the sorts
// of steps 2 and 3 of the JAX package's ops/join._one_to_one_merged.
// It computes exactly what ops/kernels/join_scan._merged_dest_plain
// computes. Input: the merge sort's output, keys ascending with side-1
// elements (mpos < cap1) before side-2 elements within each equal-key run. Forward: ranks within
// the run, side-2 matches and their prefix m2cum; a matched side-2 element
// gets its slot m2cum - 1, a live side-1 element the complement of its
// candidate slot m2cum + rank, anything else the drop value n. Backward:
// the suffix minimum of the tail-gated m2cum is each run's total match
// count, which settles the side-1 candidates.
//
// The TPU ran the tiles in order and carried the scan state in SMEM. CUDA
// blocks run in no order, so both passes are single-pass scans with a
// decoupled look-back. The carry is an associative summary of a segment
// (ops/kernels/join_scan.py has it in plain Python, `segment_summary` and
// `combine`): because side 1 precedes side 2 within a run, a run is two
// live counts (n1, n2) with min(n1, n2) matches, so a segment is
//   has_head        whether a run starts in it,
//   p1, p2          live side-1 / side-2 counts before its first run head,
//   closed          matches of the runs that start and end in it,
//   t1, t2          live counts from its last run head to its end,
// and combine(A, B) closes A's open run with B's leading counts. Dead
// (sentinel-key) elements count for nothing. The backward carry is a min.
//
// A block takes a ticket (atomicAdd), so every block it looks back at is
// already resident. It publishes the summary of its own elements as soon as
// its local scans are done, waiting for nobody. Then warp 0 looks back, 32
// records at a time, combining aggregates in order until it meets a record
// that is an inclusive prefix, and the block publishes its own inclusive
// prefix. A record is one 16-byte (forward) or 8-byte (backward) word with
// its status inside, written and read by one relaxed vector access, so a
// reader sees either the aggregate or the prefix whole and no fence is
// needed. Only the elements before a block's first run head depend on the
// carry, and their matches have a closed form, so after the look-back a
// block does no further block-wide scan.
//
// What bounds it on an H100: bytes, 16 per element in each pass (keys and
// positions in, two int32 out; keys, candidates and m2cum in, one out).
// Full blocks read and write with 128-bit accesses when the arrays are
// 16-byte aligned; the last partial block takes scalar, guarded accesses.
// On an H100 at 700 W a pass over 20M int32 keys takes 0.19 ms (forward)
// and 0.15 ms (backward) of device time against 0.096 ms for its bytes
// (PERF.md); the rest is the three block scans before a block publishes
// and the look-back's wait, with 3 or 4 blocks resident per SM to hide it.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#define JS_THREADS 512
#define JS_ITEMS 8
// Resident threads per SM the compiler must leave registers for. On an
// H100 the forward pass ran best at 3 blocks of 512 threads (40 registers a
// thread; at 32 it spills), the backward pass at 4 blocks (32 registers).
#define JS_FORWARD_THREADS_PER_SM 1536
#define JS_BACKWARD_THREADS_PER_SM 2048
// The placement: threads a block, and the most blocks its grid-stride loop
// takes (about two waves of 132 SMs at 8 resident blocks each).
#define JS_PLACE_THREADS 256
#define JS_PLACE_MAX_BLOCKS 2048
#define JS_BLOCKS_PER_SM(threads) ((threads) / JS_THREADS > 0 ? (threads) / JS_THREADS : 1)
#define JS_BLOCK (JS_THREADS * JS_ITEMS)
#define JS_WARPS (JS_THREADS / 32)

// Block-local counts ride in 16-bit halves of one int.
static_assert(JS_ITEMS % 4 == 0 && JS_ITEMS <= 32, "items per thread: a multiple of 4, at most 32");
static_assert(JS_BLOCK <= 16384, "block-local counts must fit 15 bits");
static_assert(JS_THREADS % 32 == 0 && JS_THREADS <= 1024, "whole warps");

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SPIN_PAUSE_NS = 20;  // between two reads of an unwritten record
constexpr int ST_NONE = 0;       // record not written yet (the state is zeroed)
constexpr int ST_AGGREGATE = 1;  // the block's own elements
constexpr int ST_PREFIX = 2;     // everything up to and including the block

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
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x = op(x, y);
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < JS_WARPS ? warp_tot[lane] : identity;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, w, off);
      if (lane >= off) w = op(w, y);
    }
    if (lane < JS_WARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  const int before_warp = warp > 0 ? warp_tot[warp - 1] : identity;
  int before_lane = __shfl_up_sync(FULL, x, 1);
  if (lane == 0) before_lane = identity;
  *total = warp_tot[JS_WARPS - 1];
  __syncthreads();  // warp_tot is reused by the next scan
  return op(before_warp, before_lane);
}

// --- a thread's JS_ITEMS consecutive elements --------------------------------

__device__ __forceinline__ void unpack16(const int4& x, int32_t* o) {
  o[0] = x.x;
  o[1] = x.y;
  o[2] = x.z;
  o[3] = x.w;
}
__device__ __forceinline__ void unpack16(const int4& x, int64_t* o) {
  o[0] = (int64_t)(((uint64_t)(uint32_t)x.y << 32) | (uint32_t)x.x);
  o[1] = (int64_t)(((uint64_t)(uint32_t)x.w << 32) | (uint32_t)x.z);
}

// out[q] = p[i0 + q]; `vec` (the whole block lies inside the array and the
// array is 16-byte aligned) takes 128-bit loads, else out-of-range items
// get `fill`.
template <typename T>
__device__ __forceinline__ void load_items(const T* __restrict__ p, int64_t i0, int64_t n, bool vec,
                                           T fill, T (&out)[JS_ITEMS]) {
  if (vec) {
    constexpr int PER = 16 / (int)sizeof(T);
    const int4* v = reinterpret_cast<const int4*>(p + i0);
#pragma unroll
    for (int j = 0; j < JS_ITEMS / PER; ++j) unpack16(__ldg(v + j), &out[j * PER]);
  } else {
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) out[q] = i0 + q < n ? p[i0 + q] : fill;
  }
}

__device__ __forceinline__ void store_items(int32_t* __restrict__ p, int64_t i0, int64_t n, bool vec,
                                            const int32_t (&v)[JS_ITEMS]) {
  if (vec) {
    int4* o = reinterpret_cast<int4*>(p + i0);
#pragma unroll
    for (int j = 0; j < JS_ITEMS / 4; ++j)
      o[j] = make_int4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  } else {
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q)
      if (i0 + q < n) p[i0 + q] = v[q];
  }
}

// --- published records --------------------------------------------------------
// One relaxed access moves a whole record, status included, so a reader
// never sees half of one. The state starts zeroed: status ST_NONE.

__device__ __forceinline__ int4 load_record16(const int4* p) {
  int4 r;
  asm volatile("ld.relaxed.gpu.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p)
               : "memory");
  return r;
}
__device__ __forceinline__ void store_record16(int4* p, const int4& r) {
  asm volatile("st.relaxed.gpu.v4.s32 [%0], {%1, %2, %3, %4};"
               :
               : "l"(p), "r"(r.x), "r"(r.y), "r"(r.z), "r"(r.w)
               : "memory");
}
__device__ __forceinline__ unsigned long long load_record8(const unsigned long long* p) {
  unsigned long long r;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(r) : "l"(p) : "memory");
  return r;
}
__device__ __forceinline__ void store_record8(unsigned long long* p, unsigned long long r) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" : : "l"(p), "l"(r) : "memory");
}

// --- the forward carry --------------------------------------------------------

struct Summary {
  int has_head, p1, p2, closed, t1, t2;
};

__device__ __forceinline__ Summary empty_summary() { return Summary{0, 0, 0, 0, 0, 0}; }

// The summary of segment A followed by segment B.
__device__ __forceinline__ Summary combine(const Summary& a, const Summary& b) {
  Summary r;
  if (!b.has_head) {
    r = a;
    if (a.has_head) {
      r.t1 += b.p1;
      r.t2 += b.p2;
    } else {
      r.p1 += b.p1;
      r.p2 += b.p2;
    }
  } else if (!a.has_head) {
    r = b;
    r.p1 += a.p1;
    r.p2 += a.p2;
  } else {
    r.has_head = 1;
    r.p1 = a.p1;
    r.p2 = a.p2;
    r.closed = a.closed + min(a.t1 + b.p1, a.t2 + b.p2) + b.closed;
    r.t1 = b.t1;
    r.t2 = b.t2;
  }
  return r;
}

// An aggregate's counts are at most JS_BLOCK and share words; a prefix
// starts at element 0, which is a run head, so it has no leading counts and
// its three fields take a word each.
__device__ __forceinline__ int4 encode_aggregate(const Summary& s) {
  return make_int4(ST_AGGREGATE, (s.p1 << 16) | s.p2, (s.t1 << 16) | s.t2,
                   (s.has_head << 16) | s.closed);
}
__device__ __forceinline__ int4 encode_prefix(const Summary& s) {
  return make_int4(ST_PREFIX, s.closed, s.t1, s.t2);
}
__device__ __forceinline__ Summary decode(const int4& r) {
  if (r.x == ST_PREFIX) return Summary{1, 0, 0, r.y, r.z, r.w};
  return Summary{r.w >> 16, r.y >> 16, r.y & 0xffff, r.w & 0xffff, r.z >> 16, r.z & 0xffff};
}

__device__ __forceinline__ Summary shfl_down_summary(const Summary& s, int off) {
  return Summary{__shfl_down_sync(FULL, s.has_head, off), __shfl_down_sync(FULL, s.p1, off),
                 __shfl_down_sync(FULL, s.p2, off),       __shfl_down_sync(FULL, s.closed, off),
                 __shfl_down_sync(FULL, s.t1, off),       __shfl_down_sync(FULL, s.t2, off)};
}

// The summary of everything before block b (b >= 1), by one whole warp.
// Lane l reads the record of block j - l and waits only while that one
// record is unwritten; the nearest prefix ends the walk.
__device__ Summary look_back_forward(const int4* recs, int b) {
  const int lane = threadIdx.x & 31;
  Summary before = empty_summary();
  for (int j = b - 1;; j -= 32) {
    const int idx = j - lane;
    int status = ST_PREFIX;  // lanes past block 0 stand for an empty prefix
    Summary s = empty_summary();
    if (idx >= 0) {
      int4 r = load_record16(recs + idx);
      while (r.x == ST_NONE) {
        __nanosleep(SPIN_PAUSE_NS);
        r = load_record16(recs + idx);
      }
      status = r.x;
      s = decode(r);
    }
    const unsigned prefixes = __ballot_sync(FULL, status == ST_PREFIX);
    if (prefixes != 0 && lane > __ffs(prefixes) - 1) s = empty_summary();
    // Ordered reduction: higher lanes hold earlier blocks.
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const Summary o = shfl_down_summary(s, off);
      if (lane + off < 32) s = combine(o, s);
    }
    Summary window;
    window.has_head = __shfl_sync(FULL, s.has_head, 0);
    window.p1 = __shfl_sync(FULL, s.p1, 0);
    window.p2 = __shfl_sync(FULL, s.p2, 0);
    window.closed = __shfl_sync(FULL, s.closed, 0);
    window.t1 = __shfl_sync(FULL, s.t1, 0);
    window.t2 = __shfl_sync(FULL, s.t2, 0);
    before = combine(window, before);
    if (prefixes != 0) return before;
  }
}

// The min over the blocks that took tickets 0 .. t-1 (t >= 1).
__device__ int look_back_backward(const unsigned long long* recs, int t) {
  const int lane = threadIdx.x & 31;
  int after = INT_MAX;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - lane;
    int status = ST_PREFIX;
    int v = INT_MAX;
    if (idx >= 0) {
      unsigned long long r = load_record8(recs + idx);
      while ((int)(r >> 32) == ST_NONE) {
        __nanosleep(SPIN_PAUSE_NS);
        r = load_record8(recs + idx);
      }
      status = (int)(r >> 32);
      v = (int)(uint32_t)r;
    }
    const unsigned prefixes = __ballot_sync(FULL, status == ST_PREFIX);
    if (prefixes != 0 && lane > __ffs(prefixes) - 1) v = INT_MAX;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = min(v, __shfl_xor_sync(FULL, v, off));
    after = min(after, v);
    if (prefixes != 0) return after;
  }
}

__device__ __forceinline__ unsigned long long encode_min(int status, int v) {
  return ((unsigned long long)(uint32_t)status << 32) | (uint32_t)v;
}

// Two counts in one int: side 1 in the high half, side 2 in the low half.
__device__ __forceinline__ int hi16(int packed) { return packed >> 16; }
__device__ __forceinline__ int lo16(int packed) { return packed & 0xffff; }

template <typename KeyT>
__global__ void __launch_bounds__(JS_THREADS, JS_BLOCKS_PER_SM(JS_FORWARD_THREADS_PER_SM))
join_scan_forward_kernel(const KeyT* __restrict__ keys, const int32_t* __restrict__ mpos, int64_t n,
                         int cap1, int aligned, int32_t* __restrict__ cand,
                         int32_t* __restrict__ m2out, int32_t* state) {
  __shared__ int s_ticket;
  __shared__ int s_first;  // live counts before the block's first run head
  __shared__ int s_carry[3];
  if (threadIdx.x == 0) {
    s_ticket = atomicAdd(&state[0], 1);
    s_first = 0;
  }
  __syncthreads();
  const int b = s_ticket;
  const int64_t base = (int64_t)b * JS_BLOCK;
  const int64_t i0 = base + (int64_t)threadIdx.x * JS_ITEMS;
  const bool vec = aligned && base + JS_BLOCK <= n;
  const KeyT sent = key_sentinel<KeyT>();

  // Per item, one bit each: run head, live side-1, live side-2.
  unsigned headm = 0, w1m = 0, w2m = 0;
  {
    KeyT k[JS_ITEMS];
    int32_t mp[JS_ITEMS];
    load_items(keys, i0, n, vec, sent, k);
    load_items(mpos, i0, n, vec, (int32_t)0, mp);
    KeyT prev = (i0 > 0 && i0 - 1 < n) ? keys[i0 - 1] : sent;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      const bool valid = i0 + q < n;
      const bool live = valid && k[q] != sent;
      const bool s2 = mp[q] >= cap1;
      if (valid && (i0 + q == 0 || k[q] != prev)) headm |= 1u << q;
      if (live && !s2) w1m |= 1u << q;
      if (live && s2) w2m |= 1u << q;
      prev = k[q];
    }
  }

  // Scan 1: live counts before each thread (block-relative, both sides).
  int total;
  const int woff = block_exclusive_scan((__popc(w1m) << 16) | __popc(w2m), 0, Sum(), &total);

  // Scan 2: the live counts before the latest run head at or before each
  // thread, -1 while there is none. Both halves grow from head to head, so
  // the latest head's packed value is the maximum.
  int th_hv = -1, th_first = -1;
  {
    int c = woff;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      if (headm >> q & 1) {
        th_hv = c;
        if (th_first < 0) th_first = c;
      }
      c += ((w1m >> q & 1) << 16) | (w2m >> q & 1);
    }
  }
  int last_hv;
  const int hoff = block_exclusive_scan(th_hv, -1, Max(), &last_hv);
  if (hoff < 0 && th_first >= 0) s_first = th_first;  // one thread: the first head's

  // Scan 3: side-2 matches among the elements at or after the block's first
  // head; they do not depend on the carry. A side-2 element of run rank r
  // is matched iff r is below the run's side-1 count so far.
  unsigned matchm = 0;
  {
    int c = woff, h = hoff;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      if (headm >> q & 1) h = c;
      c += ((w1m >> q & 1) << 16) | (w2m >> q & 1);
      if (h >= 0 && (w2m >> q & 1) && lo16(c) - lo16(h) - 1 < hi16(c) - hi16(h)) matchm |= 1u << q;
    }
  }
  int mrest;
  const int moff = block_exclusive_scan(__popc(matchm), 0, Sum(), &mrest);
  // (the scan's barriers also make s_first visible to every thread)

  if (threadIdx.x < 32) {
    int4* recs = reinterpret_cast<int4*>(state + 4);
    Summary own;
    own.has_head = last_hv >= 0;
    if (own.has_head) {
      own.p1 = hi16(s_first);
      own.p2 = lo16(s_first);
      own.t1 = hi16(total) - hi16(last_hv);
      own.t2 = lo16(total) - lo16(last_hv);
      own.closed = mrest - min(own.t1, own.t2);
    } else {
      own.p1 = hi16(total);
      own.p2 = lo16(total);
      own.t1 = own.t2 = own.closed = 0;
    }
    Summary before = empty_summary();
    if (b == 0) {
      // Element 0 is a run head: the aggregate is the inclusive prefix.
      if (threadIdx.x == 0) store_record16(recs, encode_prefix(own));
    } else {
      if (threadIdx.x == 0) store_record16(recs + b, encode_aggregate(own));
      before = look_back_forward(recs, b);
      if (threadIdx.x == 0) store_record16(recs + b, encode_prefix(combine(before, own)));
    }
    if (threadIdx.x == 0) {
      // `before` starts at element 0, so it has a head and no leading counts.
      s_carry[0] = before.t1;
      s_carry[1] = before.t2;
      s_carry[2] = before.closed + min(before.t1, before.t2);
    }
  }
  __syncthreads();
  // The open run has T1 side-1 and T2 side-2 live elements before this
  // block, and M matches precede the block.
  const int T1 = s_carry[0], T2 = s_carry[1], M = s_carry[2];
  // Side-2 elements before the first head continue that run at rank T2,
  // T2 + 1, ...: the first max(T1 + a1 - T2, 0) of them are matched, where
  // a1 is the block's side-1 count before its first head.
  const int lead = last_hv >= 0 ? s_first : total;
  const int lead_matches = min(lo16(lead), max(T1 + hi16(lead) - T2, 0));

  int32_t cv[JS_ITEMS], mv[JS_ITEMS];
  {
    int c = woff, h = hoff, post = moff;
#pragma unroll
    for (int q = 0; q < JS_ITEMS; ++q) {
      if (headm >> q & 1) h = c;
      c += ((w1m >> q & 1) << 16) | (w2m >> q & 1);
      int r1, r2, pre;  // live counts of the run up to here; matches before the first head
      if (h < 0) {
        r1 = T1 + hi16(c);
        r2 = T2 + lo16(c);
        pre = min(lo16(c), max(r1 - T2, 0));
      } else {
        r1 = hi16(c) - hi16(h);
        r2 = lo16(c) - lo16(h);
        pre = lead_matches;
      }
      const bool matched = (w2m >> q & 1) && r2 - 1 < r1;
      post += matchm >> q & 1;
      const int m = M + pre + post;
      int cd = (int)n;
      if (matched) {
        cd = m - 1;
      } else if (w1m >> q & 1) {
        cd = ~(m + r1 + r2 - 1);
      }
      cv[q] = cd;
      mv[q] = m;
    }
  }
  store_items(cand, i0, n, vec, cv);
  store_items(m2out, i0, n, vec, mv);
}

template <typename KeyT>
__global__ void __launch_bounds__(JS_THREADS, JS_BLOCKS_PER_SM(JS_BACKWARD_THREADS_PER_SM))
join_scan_backward_kernel(const KeyT* __restrict__ keys, const int32_t* __restrict__ cand,
                          const int32_t* __restrict__ m2, int64_t n, int nblocks, int aligned,
                          int32_t* __restrict__ dest, int32_t* __restrict__ num_out,
                          int32_t* state) {
  __shared__ int s_ticket;
  __shared__ int s_after;
  if (threadIdx.x == 0) s_ticket = atomicAdd(&state[0], 1);
  __syncthreads();
  const int ticket = s_ticket;
  const int b = nblocks - 1 - ticket;  // tickets walk the blocks from the end
  const int64_t base = (int64_t)b * JS_BLOCK;
  // Thread 0 takes the block's last JS_ITEMS elements and walks them
  // backward, so thread order is suffix order.
  const int64_t i0 = base + (int64_t)(JS_THREADS - 1 - threadIdx.x) * JS_ITEMS;
  const bool vec = aligned && base + JS_BLOCK <= n;

  // Minimum of m2cum over the run tails at or after each item, in the thread.
  int32_t sm[JS_ITEMS], c[JS_ITEMS];
  int run_min = INT_MAX;
  {
    KeyT k[JS_ITEMS];
    int32_t m[JS_ITEMS];
    load_items(keys, i0, n, vec, (KeyT)0, k);
    load_items(m2, i0, n, vec, (int32_t)0, m);
    load_items(cand, i0, n, vec, (int32_t)0, c);
    KeyT next = i0 + JS_ITEMS < n ? keys[i0 + JS_ITEMS] : (KeyT)0;
#pragma unroll
    for (int q = JS_ITEMS - 1; q >= 0; --q) {
      const int64_t i = i0 + q;
      if (i < n && (i == n - 1 || k[q] != next)) run_min = min(run_min, m[q]);
      if (i == n - 1) *num_out = m[q];
      sm[q] = run_min;
      next = k[q];
    }
  }
  int blk_min;
  const int after_thread = block_exclusive_scan(run_min, INT_MAX, Min(), &blk_min);

  if (threadIdx.x < 32) {
    unsigned long long* recs = reinterpret_cast<unsigned long long*>(state + 4);
    int after = INT_MAX;
    if (ticket == 0) {
      if (threadIdx.x == 0) store_record8(recs, encode_min(ST_PREFIX, blk_min));
    } else {
      if (threadIdx.x == 0) store_record8(recs + ticket, encode_min(ST_AGGREGATE, blk_min));
      after = look_back_backward(recs, ticket);
      if (threadIdx.x == 0) store_record8(recs + ticket, encode_min(ST_PREFIX, min(blk_min, after)));
    }
    if (threadIdx.x == 0) s_after = after;
  }
  __syncthreads();
  const int after = min(after_thread, s_after);

  int32_t d[JS_ITEMS];
#pragma unroll
  for (int q = 0; q < JS_ITEMS; ++q) {
    const int end_m2 = min(sm[q], after);
    d[q] = c[q] < 0 ? (~c[q] < end_m2 ? ~c[q] : (int)n) : c[q];
  }
  store_items(dest, i0, n, vec, d);
}

// --- the placement ---------------------------------------------------------------
//
// join_scan_place_kernel replaces what steps 2 and 3 of the JAX package's
// ops/join._one_to_one_merged sort for: the un-merge sort keyed on mpos and,
// per table, the emit sort keyed on the row's slot (dropped rows n + row).
// The matched slots of each side are exactly 0 .. num_out-1, so a matched
// row's rank in its emit sort is its slot, and those sorts only find src[d],
// the row that feeds slot d. One pass over the merged elements knows it:
// src1[dest[i]] = mpos[i] on side 1 (mpos[i] < cap1) and src2[dest[i]] =
// mpos[i] - cap1 on side 2. A dropped element (dest = n >= out_rows) writes
// nothing, and the slots from num_out on are never written: the row gather
// writes zeros there and reads no source.
//
// What bounds it on an H100: bytes, 8 read per merged element (dest, mpos)
// and 4 written per matched one; at 20M elements at most 240 MB, 0.072 ms at
// 3.35 TB/s. The reads are 128-bit, 4 elements a thread, in a grid-stride
// loop; a scalar loop takes the n % 4 tail, and the whole array where dest
// or mpos is not 16-byte aligned. The stores are 4-byte scatters whose
// targets lie close together within a warp: the matched slots rise with the
// merged key order, and a run's side-1 and side-2 elements fill the same
// slots of the two outputs.

__device__ __forceinline__ void place_one(int32_t d, int32_t p, int cap1, int out_rows,
                                          int32_t* __restrict__ src1, int32_t* __restrict__ src2) {
  if ((uint32_t)d < (uint32_t)out_rows) {
    if (p < cap1) {
      src1[d] = p;
    } else {
      src2[d] = p - cap1;
    }
  }
}

__global__ void __launch_bounds__(JS_PLACE_THREADS)
join_scan_place_kernel(const int32_t* __restrict__ dest, const int32_t* __restrict__ mpos, int64_t n,
                       int cap1, int out_rows, int aligned, int32_t* __restrict__ src1,
                       int32_t* __restrict__ src2) {
  const int64_t stride = (int64_t)gridDim.x * JS_PLACE_THREADS;
  const int64_t t = (int64_t)blockIdx.x * JS_PLACE_THREADS + threadIdx.x;
  const int64_t nvec = aligned ? n / 4 : 0;
  const int4* dv = reinterpret_cast<const int4*>(dest);
  const int4* pv = reinterpret_cast<const int4*>(mpos);
  for (int64_t v = t; v < nvec; v += stride) {
    const int4 d = __ldg(dv + v);
    const int4 p = __ldg(pv + v);
    place_one(d.x, p.x, cap1, out_rows, src1, src2);
    place_one(d.y, p.y, cap1, out_rows, src1, src2);
    place_one(d.z, p.z, cap1, out_rows, src1, src2);
    place_one(d.w, p.w, cap1, out_rows, src1, src2);
  }
  for (int64_t i = 4 * nvec + t; i < n; i += stride)
    place_one(__ldg(dest + i), __ldg(mpos + i), cap1, out_rows, src1, src2);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" int smj_join_scan_block_size() { return JS_BLOCK; }

// state: zeroed int32 [4 + 4 * nblocks]: the ticket counter in a 16-byte
// header, then one 16-byte record per block.
extern "C" int smj_join_scan_forward(const void* keys, int key_bytes, const void* mpos,
                                     int64_t n, int cap1, void* cand, void* m2, void* state,
                                     void* stream) {
  const unsigned nblocks = (unsigned)((n + JS_BLOCK - 1) / JS_BLOCK);
  const cudaStream_t st = (cudaStream_t)stream;
  const int32_t* mp = static_cast<const int32_t*>(mpos);
  int32_t* cd = static_cast<int32_t*>(cand);
  int32_t* mo = static_cast<int32_t*>(m2);
  int32_t* sp = static_cast<int32_t*>(state);
  if (!aligned16(state)) return (int)cudaErrorMisalignedAddress;
  const int aligned = aligned16(keys) && aligned16(mpos) && aligned16(cand) && aligned16(m2);
  if (key_bytes == 4) {
    join_scan_forward_kernel<int32_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int32_t*>(keys), mp, n, cap1, aligned, cd, mo, sp);
  } else if (key_bytes == 8) {
    join_scan_forward_kernel<int64_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int64_t*>(keys), mp, n, cap1, aligned, cd, mo, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// state: zeroed int32 [4 + 2 * nblocks], not the forward pass's: the ticket
// counter in a 16-byte header, then one 8-byte record per ticket.
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
  if (!aligned16(state)) return (int)cudaErrorMisalignedAddress;
  const int aligned = aligned16(keys) && aligned16(cand) && aligned16(m2) && aligned16(dest);
  if (key_bytes == 4) {
    join_scan_backward_kernel<int32_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int32_t*>(keys), cd, mi, n, nblocks, aligned, de, no, sp);
  } else if (key_bytes == 8) {
    join_scan_backward_kernel<int64_t><<<nblocks, JS_THREADS, 0, st>>>(
        static_cast<const int64_t*>(keys), cd, mi, n, nblocks, aligned, de, no, sp);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// src1, src2: int32 [out_rows] each, written only at the matched slots.
// dest, mpos: int32 [n], n >= 1.
extern "C" int smj_join_scan_place(const void* dest, const void* mpos, int64_t n, int cap1,
                                   int out_rows, void* src1, void* src2, void* stream) {
  const int aligned = aligned16(dest) && aligned16(mpos);
  const int64_t units = aligned ? (n + 3) / 4 : n;
  int64_t blocks = (units + JS_PLACE_THREADS - 1) / JS_PLACE_THREADS;
  if (blocks > JS_PLACE_MAX_BLOCKS) blocks = JS_PLACE_MAX_BLOCKS;
  join_scan_place_kernel<<<(unsigned)blocks, JS_PLACE_THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(mpos), n, cap1, out_rows,
      aligned, static_cast<int32_t*>(src1), static_cast<int32_t*>(src2));
  return (int)cudaGetLastError();
}
