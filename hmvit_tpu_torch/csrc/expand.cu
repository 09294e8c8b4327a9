// Dense-grid expansion of compacted per-pillar rows: out[ids[m]] =
// comp[m], zeros elsewhere.  Two kernels with one contract and identical
// outputs: comp (M, C) holds one row per non-empty cell, sorted by ids
// (M,) int32; rows whose id is >= num_cells are fill and are never
// placed; should an id repeat, its first row is the one placed.  Both are
// pure placement - rows move as raw 16-, 8-, 4- or 2-byte words, whatever
// the element type - so they equal the searchsorted + gather version bit
// for bit.
//
// What bounds them on the H100: bytes, nearly all of them the output
// (67 MB at 2 x 512^2 cells x 64 bf16 against at most 7.7 MB of rows).
// So both are driven by the output and write it exactly once, zeros
// included, in whole words of consecutive addresses; there is no memset
// pass and no product.
//
// expand_rows_kernel replaces the Pallas kernel
// hmvit_tpu/ops/expand.py::_expand_kernel (expand_rows_to_dense, v1).
// The Pallas kernel fetches a fixed 2 x 4096-row slab per 4096-cell block
// and places each 128 cells with a one-hot product on the matrix unit,
// because a TPU gathers badly.  Here one block owns a 4096-cell block and
// takes its row range from the r0 table (searchsorted of the block
// starts, built by the wrapper); each thread (cell, word) finds the
// cell's row by a binary search inside that range and writes the row's
// word or zero.  The threads of one cell run the same search, so their
// loads are broadcasts.
//
// expand_rows_v2_kernel replaces the Pallas kernel
// hmvit_tpu/ops/expand.py::_expand_v2_kernel (expand_rows_to_dense_v2):
// demand-sized reads and a per-128-cell table, no search in the kernel.
// Rows [r0s[g], r0s[g + 1]) are exactly sub-block g's rows (at most 128
// when ids are unique), so one warp owns a sub-block: it stages those
// rows' ids into a 128-entry cell -> row map in shared memory and then
// writes the sub-block's 128 x C tile in order, each word copied from its
// row or zero.  The map takes the place of the Pallas kernel's staged
// data tile: a row's words are consecutive in device memory already, so
// the copy reads whole sectors without it.  The Pallas kernel's packed
// (rows, 128) buffer with byte-split ids and its decode product answer a
// rule of the TPU's DMA engine and have no counterpart here, and neither
// has its C <= 125 limit.
//
// Any grid runs: the last block (sub-block) may be short, both kernels
// stop at num_cells, and the tables have one entry per started block
// (sub-block) and one more.  The Pallas kernels' num_cells % 4096 == 0
// came from their slab layout and is not needed here.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlockCells = 4096;  // cells per block of the r0 table
constexpr int kSubCells = 128;     // cells per sub-block of the r0s table
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// comp, out as words of type W, ``words`` of them per row; grid = blocks
// of kBlockCells cells, the last one maybe short; r0 has one entry per
// block and one more.
template <typename W>
__global__ void __launch_bounds__(kThreads)
expand_rows_kernel(const W* __restrict__ comp, const int* __restrict__ ids,
                   const int* __restrict__ r0, W* __restrict__ out,
                   int words, int num_cells) {
  const int first = r0[blockIdx.x], last = r0[blockIdx.x + 1];
  const long long cell0 = (long long)blockIdx.x * kBlockCells;
  const int cells = min(kBlockCells, num_cells - (int)cell0);
  for (int t = threadIdx.x; t < cells * words; t += kThreads) {
    const int cell = t / words, w = t - cell * words;
    const int target = (int)cell0 + cell;
    int lo = first, hi = last;  // lower bound of target in ids[first, last)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ids[mid] < target) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    W v{};
    if (lo < last && ids[lo] == target) v = comp[(long long)lo * words + w];
    out[(cell0 + cell) * words + w] = v;
  }
}

// grid = groups of kWarps sub-blocks, one warp per sub-block, the last
// sub-block maybe short; r0s has one entry per sub-block and one more.
template <typename W>
__global__ void __launch_bounds__(kThreads)
expand_rows_v2_kernel(const W* __restrict__ comp, const int* __restrict__ ids,
                      const int* __restrict__ r0s, W* __restrict__ out,
                      int words, int num_cells) {
  __shared__ int row_of[kWarps][kSubCells];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = blockIdx.x * kWarps + warp;
  const int cell0 = g * kSubCells;
  if (cell0 >= num_cells) return;  // whole warps only; no block barrier
  const int cells = min(kSubCells, num_cells - cell0);
  int* map = row_of[warp];
  for (int i = lane; i < kSubCells; i += 32) map[i] = INT_MAX;
  __syncwarp();
  const int first = r0s[g], last = r0s[g + 1];
  for (int i = first + lane; i < last; i += 32) {
    const unsigned cell = (unsigned)(ids[i] - cell0);
    // the first row of a repeated id
    if (cell < (unsigned)cells) atomicMin(&map[cell], i);
  }
  __syncwarp();
  W* tile = out + (long long)cell0 * words;
  for (int t = lane; t < cells * words; t += 32) {
    const int cell = t / words, w = t - cell * words;
    const int row = map[cell];
    W v{};
    if (row != INT_MAX) v = comp[(long long)row * words + w];
    tile[t] = v;
  }
}

template <typename W, bool kV2>
int launch(const void* comp, const void* ids, const void* table, void* out,
           int words, int num_cells, cudaStream_t s) {
  constexpr int kPerBlock = kV2 ? kSubCells * kWarps : kBlockCells;
  const int blocks = (num_cells + kPerBlock - 1) / kPerBlock;
  if constexpr (kV2) {
    expand_rows_v2_kernel<W><<<blocks, kThreads, 0, s>>>(
        static_cast<const W*>(comp), static_cast<const int*>(ids),
        static_cast<const int*>(table), static_cast<W*>(out), words,
        num_cells);
  } else {
    expand_rows_kernel<W><<<blocks, kThreads, 0, s>>>(
        static_cast<const W*>(comp), static_cast<const int*>(ids),
        static_cast<const int*>(table), static_cast<W*>(out), words,
        num_cells);
  }
  return (int)cudaGetLastError();
}

// the widest word that divides a row
template <bool kV2>
int dispatch(const void* comp, const void* ids, const void* table, void* out,
             int row_bytes, int num_cells, void* stream) {
  if (row_bytes <= 0 || (row_bytes & 1) != 0 || num_cells < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_cells == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0) {
    return launch<uint4, kV2>(comp, ids, table, out, row_bytes / 16,
                              num_cells, s);
  }
  if (row_bytes % 8 == 0) {
    return launch<uint2, kV2>(comp, ids, table, out, row_bytes / 8,
                              num_cells, s);
  }
  if (row_bytes % 4 == 0) {
    return launch<uint32_t, kV2>(comp, ids, table, out, row_bytes / 4,
                                 num_cells, s);
  }
  return launch<uint16_t, kV2>(comp, ids, table, out, row_bytes / 2,
                               num_cells, s);
}

}  // namespace

// comp (M, C) and out (num_cells, C) of row_bytes bytes per row; ids (M,)
// i32 sorted; r0 (ceil(num_cells / 4096) + 1,) i32 = the first row whose
// id is >= each block start, the last entry that of num_cells.
extern "C" int hm_expand_rows(const void* comp, const void* ids,
                              const void* r0, void* out, int row_bytes,
                              int num_cells, void* stream) {
  return dispatch<false>(comp, ids, r0, out, row_bytes, num_cells, stream);
}

// The same arguments and the same output; r0s (ceil(num_cells / 128) + 1,)
// i32 = the first row whose id is >= each sub-block start, the last entry
// that of num_cells.
extern "C" int hm_expand_rows_v2(const void* comp, const void* ids,
                                 const void* r0s, void* out, int row_bytes,
                                 int num_cells, void* stream) {
  return dispatch<true>(comp, ids, r0s, out, row_bytes, num_cells, stream);
}
