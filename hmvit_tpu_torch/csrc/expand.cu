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
// (67 MB at 2 x 512^2 cells x 64 bf16 against at most 7.7 MB of rows, of
// which the serving scene fills about 1.4%).  They are pure data movement
// with no arithmetic, so the tensor cores, TMA multicast and Triton have
// nothing to add: the work is to keep the card's store path full.  Both
// kernels are one template, expand_slice_kernel, that writes the output
// exactly once, zeros included, in whole 128-byte lines per warp
// instruction for 16-byte words, as streaming stores (st.global.cs: the
// grid is more than the 50 MB L2 holds, and marking it evict-first made
// both kernels 10-12% faster on an H100); there is no memset pass and no
// product.  A block owns a slice of kSliceCells consecutive cells (2048
// blocks at serving shapes, two resident waves on 132 SMs, so the second
// wave's row location runs under the first wave's stores; slices of 512
// or 1024 cells were 7% slower) and
//   1. finds the slice's rows [first, last) - the one place where the two
//      kernels differ, as the two Pallas kernels do;
//   2. scatters them into a cell -> row map in shared memory, without
//      atomics: ids are sorted, so a row is the first of its id exactly
//      when i == first or ids[i - 1] != ids[i];
//   3. writes the slice's tile in order, each word copied from its row or
//      zero, in the widest word that divides a row.  An empty cell is a
//      zero store that touches neither ids nor comp.  Words per row are a
//      runtime value for every width: a compile-time width for the
//      serving rows (no division, unrolled groups of loads) ran no faster
//      on an H100, the division hiding under the stores.
//
// expand_rows_kernel replaces the Pallas kernel
// hmvit_tpu/ops/expand.py::_expand_kernel (expand_rows_to_dense, v1).
// The Pallas kernel fetches a fixed 2 x 4096-row slab per 4096-cell block
// (row range from the prefetched r0 table) and places each 128 cells with
// a one-hot product on the matrix unit, locating a sub-block's rows by
// counting the slab ids below its start, because a TPU gathers badly.
// Here a slice is a 16th of a 4096-cell block: its first and last rows
// come from r0 at the block's ends, and inside the block one warp finds
// them with a 32-way search of ids[r0[b], r0[b + 1]) (32 probes, one
// ballot a round: 3 dependent rounds for 4096 rows), once per slice.
//
// expand_rows_v2_kernel replaces the Pallas kernel
// hmvit_tpu/ops/expand.py::_expand_v2_kernel (expand_rows_to_dense_v2):
// demand-sized reads and a per-128-cell table.  A slice's rows are
// exactly [r0s[g], r0s[g + kSubsPerSlice]) for its first sub-block g: two
// table reads, no search.  The Pallas kernel's packed (rows, 128) buffer
// with byte-split ids and its decode product answer a rule of the TPU's
// DMA engine and have no counterpart here, and neither has its C <= 125
// limit.
//
// Any grid runs: the last slice (block, sub-block) may be short, both
// kernels stop at num_cells, and the tables have one entry per started
// block (sub-block) and one more.  The Pallas kernels' num_cells % 4096
// == 0 came from their slab layout and is not needed here.  Offsets into
// comp and out are 64-bit; both kernels run on the caller's stream.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlockCells = 4096;  // cells per block of the r0 table
constexpr int kSubCells = 128;     // cells per sub-block of the r0s table
constexpr int kSliceCells = 256;   // cells a thread block writes
constexpr int kThreads = 256;
constexpr int kSubsPerSlice = kSliceCells / kSubCells;
static_assert(kBlockCells % kSliceCells == 0 && kSliceCells % kSubCells == 0,
              "a slice lies inside one block and spans whole sub-blocks");

// The lower bound of target in ids[lo, hi), by one whole warp: each round
// probes 32 evenly spaced rows and keeps the gap the ballot points at.
__device__ int warp_lower_bound(const int* __restrict__ ids, int lo, int hi,
                                int target) {
  const int lane = threadIdx.x & 31;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int idx = lo + lane * step;
    const bool below = idx < hi && ids[idx] < target;
    const int n = __popc(__ballot_sync(0xffffffffu, below));
    if (n == 0) return lo;
    hi = min(hi, lo + n * step);
    lo += (n - 1) * step + 1;
  }
  return lo;
}

// grid = slices of kSliceCells cells, the last one maybe short.  kV2:
// table = r0s, one entry per 128-cell sub-block and one more; else table
// = r0, one entry per 4096-cell block and one more.
template <bool kV2, typename W>
__global__ void __launch_bounds__(kThreads)
expand_slice_kernel(const W* __restrict__ comp, const int* __restrict__ ids,
                    const int* __restrict__ table, W* __restrict__ out,
                    int words, int num_cells) {
  __shared__ int row_of[kSliceCells];
  __shared__ int range[2];
  const int cell0 = blockIdx.x * kSliceCells;
  const int cells = min(kSliceCells, num_cells - cell0);
  for (int i = threadIdx.x; i < kSliceCells; i += kThreads) row_of[i] = -1;

  // 1. the slice's rows [first, last)
  const int warp = threadIdx.x >> 5;
  if constexpr (kV2) {
    if (threadIdx.x < 2) {
      const int subs = (num_cells + kSubCells - 1) / kSubCells;
      const int g = blockIdx.x * kSubsPerSlice + threadIdx.x * kSubsPerSlice;
      range[threadIdx.x] = table[min(g, subs)];
    }
  } else if (warp < 2) {
    // warp 0 the first row, warp 1 the end; a block's ends are in r0
    constexpr int kSlices = kBlockCells / kSliceCells;
    const int b = blockIdx.x / kSlices, k = blockIdx.x % kSlices + warp;
    const int lo = table[b], hi = table[b + 1];
    const int r = k == 0         ? lo
                  : k == kSlices ? hi
                                 : warp_lower_bound(ids, lo, hi,
                                                    cell0 + warp * kSliceCells);
    if ((threadIdx.x & 31) == 0) range[warp] = r;
  }
  __syncthreads();

  // 2. the cell -> row map: the first row of each id
  const int first = range[0], last = range[1];
  for (int i = first + threadIdx.x; i < last; i += kThreads) {
    const int id = ids[i];
    const unsigned cell = (unsigned)(id - cell0);
    if (cell < (unsigned)cells && (i == first || ids[i - 1] != id)) {
      row_of[cell] = i;
    }
  }
  __syncthreads();

  // 3. the tile: cells x words words of W, each from its row or zero
  W* __restrict__ tile = out + (long long)cell0 * words;
  for (int f = threadIdx.x; f < cells * words; f += kThreads) {
    const int cell = f / words;
    const int row = row_of[cell];
    const W v =
        row >= 0 ? comp[(long long)row * words + (f - cell * words)] : W{};
    __stcs(tile + f, v);
  }
}

template <bool kV2, typename W>
int launch(const void* comp, const void* ids, const void* table, void* out,
           int words, int num_cells, cudaStream_t s) {
  const int blocks = (num_cells + kSliceCells - 1) / kSliceCells;
  expand_slice_kernel<kV2, W><<<blocks, kThreads, 0, s>>>(
      static_cast<const W*>(comp), static_cast<const int*>(ids),
      static_cast<const int*>(table), static_cast<W*>(out), words,
      num_cells);
  return (int)cudaGetLastError();
}

// Rows in the widest word that divides them.
template <bool kV2>
int dispatch(const void* comp, const void* ids, const void* table, void* out,
             int row_bytes, int num_cells, void* stream) {
  if (row_bytes <= 0 || (row_bytes & 1) != 0 || num_cells < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (num_cells == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (row_bytes % 16 == 0) {
    return launch<kV2, uint4>(comp, ids, table, out, row_bytes / 16,
                              num_cells, s);
  }
  if (row_bytes % 8 == 0) {
    return launch<kV2, uint2>(comp, ids, table, out, row_bytes / 8,
                              num_cells, s);
  }
  if (row_bytes % 4 == 0) {
    return launch<kV2, uint32_t>(comp, ids, table, out, row_bytes / 4,
                                 num_cells, s);
  }
  return launch<kV2, uint16_t>(comp, ids, table, out, row_bytes / 2,
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
