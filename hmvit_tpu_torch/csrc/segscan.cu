// One-pass inclusive segmented max-scan over pillar-sorted point rows,
// and the previous form of its kernel, kept for timing.
//
// segmented_max_scan_kernel replaces the Pallas kernel
// hmvit_tpu/ops/segscan.py::_kernel (fused_segmented_max_scan).  The
// contract: vals (P, C), ids (P,) int32 in which every id >= 0 occupies
// one run of consecutive rows no longer than 2^steps; out[r] is the
// maximum of vals over the rows of r's run up to and including r, so the
// last row of a run holds the run's maximum.  Rows of a negative
// ("dropped") id are unspecified, as in the Pallas kernel and in the
// log-shift scan: nothing downstream reads them.  Here they are copied
// through, and no run is joined across one (the padding of a cloud is
// one long run of them, longer than 2^steps).
//
// The Pallas kernel walks row blocks in order and carries the last run's
// (id, maximum) from one grid step to the next; CUDA blocks run in no
// order, so the carry is computed instead.  The design:
//   * the tile: a block owns R consecutive rows and a group of up to 32
//     channel vectors (8 channels as one 16-byte bf16 / 32-byte fp32
//     word when C % 8 == 0, else one channel); a thread owns one vector
//     over a slice of kSlice = 8 consecutive rows, and the block has 256
//     threads, so R = 8 * 256 / group: 256 rows at C = 64.  A warp's load
//     covers 4 whole 128-byte rows (bf16, C = 64).  The tile's ids go to
//     shared memory; the values stay in registers.
//   * inside the tile the scan is linear: each thread keeps a running
//     maximum down its slice, reset where the id changes; the slice tails
//     go to shared memory, and the carry into a slice's first run is the
//     maximum of the tails of the earlier slices that run reaches, walked
//     back a slice at a time (a tile inside one run: 32 * 31 / 2 tail
//     merges a vector, about 2 a row; a binary search for the run's start
//     measured slower).  The result is written
//     back with 16-byte stores (plain: the second launch below reads them
//     back; evict-first stores measured no faster).
//   * the head carry: only the tile's first run can begin before the
//     tile; its carry is the maximum of that run's rows before r0,
//     computed once per block (head_carry).  By the contract those rows
//     are at most 2^steps - 1.  When 2^steps - 1 <= R (the serving
//     contract: steps 5, 31 rows) the block reads them from vals (the
//     previous tile's last rows): one launch.
//   * longer runs (2^steps - 1 > R: steps = ceil(log2 P) where no point
//     cap bounds the runs)
//     take a second launch, segmented_max_scan_carry_kernel: after the
//     first launch has written every tile's in-tile scan, a tile whose
//     first run began earlier takes the maximum of the LAST row of each
//     earlier tile the run covers (that row holds the run's maximum
//     within its tile) and applies it to its head run.  A tile's last row
//     may meanwhile be raised by its own block to the run's maximum up to
//     it: either value is a maximum over rows of the same run before r0,
//     and the union is all of them, so the race is benign (max is
//     idempotent).  No flags, no scratch, no block waits on another.
//     Cost of a run of L rows spanning T = L / R tiles: its L rows twice
//     (read and written by both launches where the run covers a tile's
//     head) plus T^2 / 2 tail rows, 120 at L = 4096, R = 256 (3% of L).
//     It is the look-back over a coarser unit, not a chained scan: the
//     work is linear in rows for runs up to R and grows as (L / R)^2
//     tail rows beyond.
//   * the maximum is exact in any order; every combine keeps the later
//     rows' value on a tie (of -0 and +0), as the previous body does, and
//     NaN propagates (max_nan), as in torch.maximum.  Every offset is
//     32-bit when P * C < 2^31.
//
// What bounds it on the H100: bytes (each value read and written once,
// plus the ids: 15.6 MB at 60 000 x 64 bf16, 4.7 us at 3.35 TB/s).  The
// serving launch is 235 blocks, one wave: its time is the latency of a
// block (one round trip for ids and values, one for the head rows, the
// stores) on top of the bytes.
//
// segmented_max_scan_previous_kernel is the previous body (one thread per
// (row, 8 channels) looking back over its run a row at a time: L^2 / 2
// row loads for a run of L rows), reached only through
// hm_segmented_max_scan_previous: the on-card bit anchor of the kernel
// here and its timing yardstick.
#include "numeric.cuh"

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kSlice = 8;      // consecutive rows a thread scans
constexpr int kMaxGroup = 32;  // channel vectors a block

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

// a = max(a, b) per channel; a holds the later rows (kept on a tie)
template <int V>
__device__ __forceinline__ void merge(float a[V], const float b[V]) {
#pragma unroll
  for (int e = 0; e < V; ++e) a[e] = max_nan(a[e], b[e]);
}

// V consecutive channels of one row: 8 as whole words, or 1
template <typename T, int V>
__device__ __forceinline__ void load_channels(const T* p, float v[V]) {
  if constexpr (V == 1) {
    v[0] = hm::to_f(*p);
  } else {
    hm::load_vec<T, V>(p, v);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_channels(T* p, const float v[V]) {
  if constexpr (V == 1) {
    *p = hm::from_f<T>(v[0]);
  } else {
    hm::store_vec<T, V>(p, v);
  }
}

// The block's place: thread (slice s, vector j of the group), tile rows
// r0 .. r0 + n - 1.
struct Tile {
  int slices, rows, r0, n, s, j, cv, first;
  bool active;  // the thread's vector exists (the last group may be short)
  __device__ Tile(int p, int cvecs, int vg) {
    slices = blockDim.x / vg;
    rows = slices * kSlice;
    r0 = blockIdx.x * rows;
    n = min(rows, p - r0);
    s = threadIdx.x / vg;
    j = threadIdx.x - s * vg;
    cv = blockIdx.y * vg + j;
    active = cv < cvecs;
    first = s * kSlice;
  }
};

// The carry of a tile whose first run (id0) began before it: the maximum
// of src over the candidate rows last - k * step (k < count) that hold
// id0, into head[j * V ..] for each vector j of the group.  By the
// contract the rows of id0 are consecutive, so the candidates that hold
// it are k < held: the block counts them a batch of `slices` ids at a
// time (id_first: candidate k = s, loaded by the caller), then each
// slice takes a contiguous chunk of them (its loads all in flight) and
// the chunks are reduced in order, later rows first.  The caller has
// checked that candidate 0 holds id0.  Called by every thread.
template <typename T, int V, typename I>
__device__ void head_carry(const T* src, const int* __restrict__ ids,
                           int id0, int id_first, int last, int step,
                           int count, int cvecs, int vg, const Tile& t,
                           float* part, float* head) {
  int held = 0;
  for (int base = 0; base < count; base += t.slices) {
    const int k = base + t.s;
    int id = -1;
    if (k < count) id = base == 0 ? id_first : ids[last - k * step];
    const int n = __syncthreads_count(t.j == 0 && id == id0);
    held += n;
    if (n < t.slices) break;
  }
  const int chunk = (held + t.slices - 1) / t.slices;
  const int k0 = t.s * chunk, k1 = min(held, k0 + chunk);
  if (t.active && k0 < k1) {
    float acc[V];
    load_channels<T, V>(src + ((I)(last - k0 * step) * cvecs + t.cv) * V,
                        acc);
#pragma unroll 4
    for (int k = k0 + 1; k < k1; ++k) {
      float v[V];
      load_channels<T, V>(src + ((I)(last - k * step) * cvecs + t.cv) * V,
                          v);
      merge<V>(acc, v);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) part[threadIdx.x * V + e] = acc[e];
  }
  __syncthreads();
  if (t.s == 0 && t.active) {
    const int used = (held + chunk - 1) / chunk;
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = part[t.j * V + e];
    for (int q = 1; q < used; ++q) {
      float v[V];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] = part[(q * vg + t.j) * V + e];
      merge<V>(acc, v);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) head[t.j * V + e] = acc[e];
  }
  __syncthreads();
}

// The scan of each tile; with lookback > 0 (= 2^steps - 1 <= R) also the
// head carry from the rows before the tile, else the carry kernel below
// adds it.  grid (tiles, vector groups), block (R / kSlice) * vg threads.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
segmented_max_scan_kernel(const T* __restrict__ vals,
                          const int* __restrict__ ids, T* __restrict__ out,
                          int p, int cvecs, int vg, int lookback) {
  __shared__ int tile_ids[kThreads * kSlice];
  __shared__ __align__(16) float part[kThreads * V];
  __shared__ __align__(16) float head[kMaxGroup * V];
  const Tile t(p, cvecs, vg);

  // one round trip: the tile's ids, the thread's rows, and the ids that
  // decide the head carry
  for (int k = threadIdx.x; k < t.rows; k += blockDim.x) {
    tile_ids[k] = k < t.n ? ids[t.r0 + k] : -1;
  }
  float v[kSlice][V];
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    if (t.active && t.first + i < t.n) {
      load_channels<T, V>(vals + ((I)(t.r0 + t.first + i) * cvecs + t.cv)
                                     * V, v[i]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[i][e] = 0.f;
    }
  }
  const int count = min(lookback, t.r0);
  const int id0 = ids[t.r0];
  const int id_first = t.s < count ? ids[t.r0 - 1 - t.s] : -1;
  const bool carried = count > 0 && id0 >= 0 && ids[t.r0 - 1] == id0;
  __syncthreads();
  if (carried) {  // uniform
    head_carry<T, V, I>(vals, ids, id0, id_first, t.r0 - 1, 1, count, cvecs,
                        vg, t, part, head);
  }

  // the slice's own running maximum, reset where the id changes
#pragma unroll
  for (int i = 1; i < kSlice; ++i) {
    const int id = tile_ids[t.first + i];
    if (id >= 0 && id == tile_ids[t.first + i - 1]) merge<V>(v[i], v[i - 1]);
  }
  if (t.active) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      part[threadIdx.x * V + e] = v[kSlice - 1][e];
    }
  }
  __syncthreads();
  if (!t.active || t.first >= t.n) return;

  // the carry into the slice's first run: the tails of the earlier
  // slices whose last row it holds (a suffix of the slices before this
  // one), later first, then the head carry if the run began before the
  // tile
  const int id_s = tile_ids[t.first];
  float carry[V];
  bool has = false;
  if (id_s >= 0 && t.s > 0 && tile_ids[t.first - 1] == id_s) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      carry[e] = part[((t.s - 1) * vg + t.j) * V + e];
    }
    for (int q = t.s - 2;
         q >= 0 && tile_ids[q * kSlice + kSlice - 1] == id_s; --q) {
      float tail[V];
#pragma unroll
      for (int e = 0; e < V; ++e) tail[e] = part[(q * vg + t.j) * V + e];
      merge<V>(carry, tail);
    }
    has = true;
  }
  if (carried && id_s == id0) {
    float h[V];
#pragma unroll
    for (int e = 0; e < V; ++e) h[e] = head[t.j * V + e];
    if (has) {
      merge<V>(carry, h);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) carry[e] = h[e];
    }
    has = true;
  }
  if (has) {  // the slice's first run: a prefix of its rows
    bool in = true;
#pragma unroll
    for (int i = 0; i < kSlice; ++i) {
      in = in && tile_ids[t.first + i] == id_s;
      if (in) merge<V>(v[i], carry);
    }
  }
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    if (t.first + i < t.n) {
      store_channels<T, V>(out + ((I)(t.r0 + t.first + i) * cvecs + t.cv)
                                     * V, v[i]);
    }
  }
}

// The second launch for runs longer than a tile (2^steps - 1 > R): a tile
// whose first run began before it takes the maximum of the last row of
// each earlier tile of that run (written by the first launch) and applies
// it to its head run.  Same grid and block as the first launch.
template <typename T, int V, typename I>
__global__ void __launch_bounds__(kThreads)
segmented_max_scan_carry_kernel(const int* __restrict__ ids, T* out, int p,
                                int cvecs, int vg) {
  __shared__ __align__(16) float part[kThreads * V];
  __shared__ __align__(16) float head[kMaxGroup * V];
  const Tile t(p, cvecs, vg);
  if (t.r0 == 0) return;
  const int id0 = ids[t.r0];
  if (id0 < 0 || ids[t.r0 - 1] != id0) return;  // uniform
  const int count = blockIdx.x;  // the earlier tiles
  const int id_first = t.s < count ? ids[t.r0 - 1 - t.s * t.rows] : -1;
  head_carry<T, V, I>(out, ids, id0, id_first, t.r0 - 1, t.rows, count,
                      cvecs, vg, t, part, head);
  if (!t.active) return;
  bool in[kSlice];
  bool any = false;
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    in[i] = t.first + i < t.n && ids[t.r0 + t.first + i] == id0;
    any = any || in[i];
  }
  if (!any) return;
  float carry[V];
#pragma unroll
  for (int e = 0; e < V; ++e) carry[e] = head[t.j * V + e];
  float v[kSlice][V];
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    if (in[i]) {
      load_channels<T, V>(out + ((I)(t.r0 + t.first + i) * cvecs + t.cv) * V,
                          v[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kSlice; ++i) {
    if (in[i]) {
      merge<V>(v[i], carry);
      store_channels<T, V>(out + ((I)(t.r0 + t.first + i) * cvecs + t.cv)
                                     * V, v[i]);
    }
  }
}

// The previous body: one thread per (row, V channels), looking back over
// its own run a row at a time.
template <typename T, int V>
__global__ void segmented_max_scan_previous_kernel(
    const T* __restrict__ vals, const int* __restrict__ ids,
    T* __restrict__ out, int p, int c, int window) {
  const int cvecs = c / V;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)p * cvecs) return;
  const int r = (int)(idx / cvecs);
  const int cv = (int)(idx - (long long)r * cvecs);
  const int id = ids[r];
  float acc[V];
  load_channels<T, V>(vals + idx * V, acc);
  const int reach = id < 0 ? 1 : min(window, r + 1);
  for (int k = 1; k < reach && ids[r - k] == id; ++k) {
    float v[V];
    load_channels<T, V>(vals + ((long long)(r - k) * cvecs + cv) * V, v);
    merge<V>(acc, v);
  }
  store_channels<T, V>(out + idx * V, acc);
}

// The tiling of C channels: vectors a block (vg), rows a tile.
struct Plan {
  int cvecs, vg, slices, rows;
  Plan(int c, int v) {
    cvecs = c / v;
    vg = cvecs < kMaxGroup ? cvecs : kMaxGroup;
    slices = kThreads / vg;
    rows = slices * kSlice;
  }
};

template <typename T, int V, typename I>
int launch_tiles(const void* vals, const void* ids, void* out, int p,
                 const Plan& plan, int steps, cudaStream_t s) {
  const int lookback = (1 << steps) - 1;
  const bool two_pass = lookback > plan.rows;
  const dim3 grid((unsigned)((p + plan.rows - 1) / plan.rows),
                  (unsigned)((plan.cvecs + plan.vg - 1) / plan.vg));
  const dim3 block((unsigned)(plan.slices * plan.vg));
  const int* id = static_cast<const int*>(ids);
  segmented_max_scan_kernel<T, V, I><<<grid, block, 0, s>>>(
      static_cast<const T*>(vals), id, static_cast<T*>(out), p, plan.cvecs,
      plan.vg, two_pass ? 0 : lookback);
  if (two_pass && grid.x > 1) {
    segmented_max_scan_carry_kernel<T, V, I><<<grid, block, 0, s>>>(
        id, static_cast<T*>(out), p, plan.cvecs, plan.vg);
  }
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_any_index(const void* vals, const void* ids, void* out, int p,
                     int c, int steps, cudaStream_t s) {
  const Plan plan(c, V);
  return (long long)p * c < (1LL << 31)
             ? launch_tiles<T, V, int>(vals, ids, out, p, plan, steps, s)
             : launch_tiles<T, V, long long>(vals, ids, out, p, plan, steps,
                                             s);
}

template <typename T>
int launch_any_c(const void* vals, const void* ids, void* out, int p, int c,
                 int steps, cudaStream_t s) {
  return (c & 7) == 0 ? launch_any_index<T, 8>(vals, ids, out, p, c, steps, s)
                      : launch_any_index<T, 1>(vals, ids, out, p, c, steps, s);
}

template <typename T, int V>
int launch_previous(const void* vals, const void* ids, void* out, int p,
                    int c, int steps, cudaStream_t s) {
  const long long total = (long long)p * (c / V);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  segmented_max_scan_previous_kernel<T, V><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const int*>(ids),
      static_cast<T*>(out), p, c, 1 << steps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_previous_any_c(const void* vals, const void* ids, void* out,
                          int p, int c, int steps, cudaStream_t s) {
  return (c & 7) == 0 ? launch_previous<T, 8>(vals, ids, out, p, c, steps, s)
                      : launch_previous<T, 1>(vals, ids, out, p, c, steps, s);
}

using Launch = int (*)(const void*, const void*, void*, int, int, int,
                       cudaStream_t);

int dispatch(Launch f32, Launch bf16, const void* vals, const void* ids,
             void* out, int dtype, int p, int c, int steps, void* stream) {
  if (c < 0 || steps < 0 || steps > 30 || p < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)p * c == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32(vals, ids, out, p, c, steps, s);
  if (dtype == 1) return bf16(vals, ids, out, p, c, steps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// vals, out (P, C); ids (P,) i32; runs of ids >= 0 are at most 2^steps
// rows.  dtype 0 = f32, 1 = bf16.
extern "C" int hm_segmented_max_scan(const void* vals, const void* ids,
                                     void* out, int dtype, int p, int c,
                                     int steps, void* stream) {
  return dispatch(launch_any_c<float>, launch_any_c<__nv_bfloat16>, vals,
                  ids, out, dtype, p, c, steps, stream);
}

// The previous body of hm_segmented_max_scan, for timing: the same
// arguments and, on every row whose id is >= 0, the same output bits.
extern "C" int hm_segmented_max_scan_previous(const void* vals,
                                              const void* ids, void* out,
                                              int dtype, int p, int c,
                                              int steps, void* stream) {
  return dispatch(launch_previous_any_c<float>,
                  launch_previous_any_c<__nv_bfloat16>, vals, ids, out,
                  dtype, p, c, steps, stream);
}

// Rows a tile of hm_segmented_max_scan holds for C channels, negated when
// `steps` makes it take the second (carry) launch; mirrored by
// hmvit_tpu_torch/ops/segscan.py::scan_plan.
extern "C" int hm_segmented_max_scan_plan(int c, int steps) {
  if (c <= 0 || steps < 0 || steps > 30) return 0;
  const Plan plan(c, (c & 7) == 0 ? 8 : 1);
  return (1 << steps) - 1 > plan.rows ? -plan.rows : plan.rows;
}
