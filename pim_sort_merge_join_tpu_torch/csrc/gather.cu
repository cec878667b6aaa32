// Row gather for the PyTorch port: for each part p,
//   out[i, off_p + q] = src_p[idx_p[i], cols_p[q]].
//
// Replaces, for payloads that are the rows of a table, the payload planes
// that rode every pass of the TPU sort (pim_sort_merge_join_tpu/ops/pallas/
// hbm_sort.py, the non-key operands of hbm_sort), and the row takes of the
// join's emit. On the TPU each column was its own plane. On the card the
// table is row-major, and a random 4- or 8-byte read costs a whole 32-byte
// sector: gathering column by column reads a row's sector once per column.
//
// What bounds it on an H100: bytes. The indices, one sector per row read and
// the kept columns written, each once. The design keeps to that:
//   - one thread reads one source row of each part with 16-byte loads (a row
//     of four int64 is exactly one sector, fetched once), all of a row's
//     loads started before the first is used;
//   - the block's rows go through shared memory, so that the stores run
//     along the output's rows, neighbouring threads on neighbouring
//     elements, whatever the kept columns;
//   - up to two parts (a join's two tables, each with its own index) fill
//     neighbouring column windows of the same output rows in one launch.
//     Where the windows make up the whole row the block's stores are one
//     contiguous piece: every 32-byte sector is written whole and once. Two
//     launches, one per window, would each leave part of every sector for
//     the other, and a partly written sector costs a read as well;
//   - rows from min(*live, n_idx_p) on are written as zeros and read
//     nothing, so the caller needs no masking pass over the output.
// Rows whose byte length is not a multiple of 16, or a misaligned source,
// are read word by word. A part may be a slice of a wider table's columns:
// it has a row pitch of its own, and the caller cuts rows wider than
// SMJ_ROWS_MAX_BYTES into such slices (ops/kernels/gather.py), one launch
// for every two, `out` moved on to each launch's first column. The kernel
// trusts the indices to be in range.

#include <cstdint>
#include <cuda_runtime.h>

#define SMJ_ROWS_THREADS 256
#define SMJ_ROWS_MAX_BYTES 64
#define SMJ_ROWS_MAX_WORDS (SMJ_ROWS_MAX_BYTES / 4)
#define SMJ_ROWS_MAX_PARTS 2
#define SMJ_ROWS_MAX_COLS (SMJ_ROWS_MAX_PARTS * SMJ_ROWS_MAX_WORDS)

namespace {

struct RowsPart {
  const unsigned char* src;
  const int32_t* idx;
  int64_t n_idx;
  int64_t pitch_bytes;  // from one source row to the next
  int row_bytes;        // of a row, the part that is read
  int chunks;  // 16-byte pieces of an aligned row, or 0: read it word by word
};

struct RowsArgs {
  RowsPart part[SMJ_ROWS_MAX_PARTS];
  int nparts;
  int ncols;                                  // kept columns of all parts
  unsigned char part_of[SMJ_ROWS_MAX_COLS];   // per output column: its part
  unsigned char col_of[SMJ_ROWS_MAX_COLS];    // and its column there
};

__global__ void __launch_bounds__(SMJ_ROWS_THREADS)
gather_rows_kernel(RowsArgs a, int elem_bytes, const int32_t* __restrict__ live,
                   unsigned char* __restrict__ out, int64_t m, int64_t pitch) {
  extern __shared__ __align__(16) unsigned char smj_rows_tile[];
  __shared__ int part_of[SMJ_ROWS_MAX_COLS], col_of[SMJ_ROWS_MAX_COLS];
  const int tid = threadIdx.x;
  if (tid < a.ncols) {
    part_of[tid] = a.part_of[tid];
    col_of[tid] = a.col_of[tid];
  }
  int64_t cap = m;
  if (live != nullptr) {
    const int64_t l = *live;
    cap = l < cap ? (l < 0 ? 0 : l) : cap;
  }
  const int64_t row0 = (int64_t)blockIdx.x * SMJ_ROWS_THREADS;
  const int64_t i = row0 + tid;
  int64_t lim[SMJ_ROWS_MAX_PARTS];
  unsigned char* tile[SMJ_ROWS_MAX_PARTS];
  uint32_t v[SMJ_ROWS_MAX_PARTS][SMJ_ROWS_MAX_WORDS];
  const unsigned char* row[SMJ_ROWS_MAX_PARTS];
#pragma unroll
  for (int p = 0; p < SMJ_ROWS_MAX_PARTS; ++p) {
    lim[p] = 0;
    tile[p] = smj_rows_tile;
    row[p] = nullptr;
    if (p < a.nparts) {
      lim[p] = cap < a.part[p].n_idx ? cap : a.part[p].n_idx;
      if (p > 0) tile[p] = tile[p - 1] + SMJ_ROWS_THREADS * a.part[p - 1].row_bytes;
      if (i < lim[p]) row[p] = a.part[p].src + (int64_t)a.part[p].idx[i] * a.part[p].pitch_bytes;
    }
  }
#pragma unroll
  for (int p = 0; p < SMJ_ROWS_MAX_PARTS; ++p) {
    if (row[p] != nullptr) {
      if (a.part[p].chunks > 0) {
#pragma unroll
        for (int c = 0; c < SMJ_ROWS_MAX_WORDS / 4; ++c) {
          if (c < a.part[p].chunks) {
            const uint4 t = __ldg(reinterpret_cast<const uint4*>(row[p]) + c);
            v[p][4 * c] = t.x, v[p][4 * c + 1] = t.y, v[p][4 * c + 2] = t.z, v[p][4 * c + 3] = t.w;
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < SMJ_ROWS_MAX_WORDS; ++c) {
          if (4 * c < a.part[p].row_bytes) {
            v[p][c] = __ldg(reinterpret_cast<const uint32_t*>(row[p]) + c);
          }
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < SMJ_ROWS_MAX_PARTS; ++p) {
    if (row[p] != nullptr) {
      unsigned char* mine = tile[p] + (int64_t)tid * a.part[p].row_bytes;
      if (a.part[p].chunks > 0) {
#pragma unroll
        for (int c = 0; c < SMJ_ROWS_MAX_WORDS / 4; ++c) {
          if (c < a.part[p].chunks) {
            reinterpret_cast<uint4*>(mine)[c] =
                make_uint4(v[p][4 * c], v[p][4 * c + 1], v[p][4 * c + 2], v[p][4 * c + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < SMJ_ROWS_MAX_WORDS; ++c) {
          if (4 * c < a.part[p].row_bytes) reinterpret_cast<uint32_t*>(mine)[c] = v[p][c];
        }
      }
    }
  }
  __syncthreads();
  const int64_t rest = m - row0;
  const int rows = rest < SMJ_ROWS_THREADS ? (int)rest : SMJ_ROWS_THREADS;
  const int k = a.ncols;
  for (int e = tid; e < rows * k; e += SMJ_ROWS_THREADS) {
    const int r = e / k, q = e - r * k;
    const int p = part_of[q];
    const bool real = row0 + r < (p == 0 ? lim[0] : lim[SMJ_ROWS_MAX_PARTS - 1]);
    const unsigned char* from = p == 0 ? tile[0] : tile[SMJ_ROWS_MAX_PARTS - 1];
    const int row_bytes = p == 0 ? a.part[0].row_bytes : a.part[SMJ_ROWS_MAX_PARTS - 1].row_bytes;
    const int64_t o = (row0 + r) * pitch + q;
    if (elem_bytes == 8) {
      reinterpret_cast<int64_t*>(out)[o] =
          real ? *reinterpret_cast<const int64_t*>(from + r * row_bytes + col_of[q] * 8) : 0;
    } else {
      reinterpret_cast<int32_t*>(out)[o] =
          real ? *reinterpret_cast<const int32_t*>(from + r * row_bytes + col_of[q] * 4) : 0;
    }
  }
}

static_assert(SMJ_ROWS_MAX_PARTS == 2, "the write-out picks between a first and a last part");

}  // namespace

extern "C" int smj_gather_rows_max_bytes() { return SMJ_ROWS_MAX_BYTES; }

extern "C" int smj_gather_rows_max_parts() { return SMJ_ROWS_MAX_PARTS; }

// For each part p < nparts: out[i, off_p + q] = srcs[p][idxs[p][i],
// cols_p[q]] for i < min(m, n_idxs[p], *live), zeros for the other i < m;
// off_p counts the kept columns of the parts before p and cols_p are the
// next ncols[p] entries of `cols`. srcs[p] holds rows of ws[p] elements,
// pitches[p] elements apart; out is row-major [m, pitch]; all of elem_bytes
// (4 or 8) per element; the indices int32; live a device int32 or null. `m`
// may be 0.
extern "C" int smj_gather_rows(int nparts, const void* const* srcs, const int* ws,
                               const int64_t* pitches, const void* const* idxs,
                               const int64_t* n_idxs, const int* ncols, const int* cols,
                               int elem_bytes, const void* live, void* out, int64_t m,
                               int64_t pitch, void* stream) {
  if ((elem_bytes != 4 && elem_bytes != 8) || nparts < 1 || nparts > SMJ_ROWS_MAX_PARTS ||
      m < 0 || (m + SMJ_ROWS_THREADS - 1) / SMJ_ROWS_THREADS > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  RowsArgs a;
  a.nparts = nparts;
  a.ncols = 0;
  size_t shared = 0;
  for (int p = 0; p < nparts; ++p) {
    const int row_bytes = ws[p] * elem_bytes;
    if (ws[p] < 1 || row_bytes > SMJ_ROWS_MAX_BYTES || ncols[p] < 1 ||
        ncols[p] > SMJ_ROWS_MAX_WORDS || n_idxs[p] < 0 || pitches[p] < ws[p]) {
      return (int)cudaErrorInvalidValue;
    }
    const int64_t pitch_bytes = pitches[p] * elem_bytes;
    const bool vec = row_bytes % 16 == 0 && pitch_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(srcs[p]) % 16 == 0;
    a.part[p] = RowsPart{static_cast<const unsigned char*>(srcs[p]),
                         static_cast<const int32_t*>(idxs[p]), n_idxs[p], pitch_bytes, row_bytes,
                         vec ? row_bytes / 16 : 0};
    for (int q = 0; q < ncols[p]; ++q) {
      const int col = *cols++;
      if (col < 0 || col >= ws[p]) return (int)cudaErrorInvalidValue;
      a.part_of[a.ncols] = (unsigned char)p;
      a.col_of[a.ncols++] = (unsigned char)col;
    }
    shared += (size_t)SMJ_ROWS_THREADS * row_bytes;
  }
  if (a.ncols > pitch) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  const int64_t blocks = (m + SMJ_ROWS_THREADS - 1) / SMJ_ROWS_THREADS;
  gather_rows_kernel<<<(unsigned)blocks, SMJ_ROWS_THREADS, shared, (cudaStream_t)stream>>>(
      a, elem_bytes, static_cast<const int32_t*>(live), static_cast<unsigned char*>(out), m,
      pitch);
  return (int)cudaGetLastError();
}
