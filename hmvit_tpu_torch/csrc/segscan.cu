// One-pass inclusive segmented max-scan over pillar-sorted point rows.
//
// segmented_max_scan_kernel replaces the Pallas kernel
// hmvit_tpu/ops/segscan.py::_kernel (fused_segmented_max_scan).  The
// contract: vals (P, C), ids (P,) int32 in which every id >= 0 occupies
// one run of consecutive rows no longer than 2^steps; out[r] is the
// maximum of vals over the rows of r's run up to and including r, so the
// last row of a run holds the run's maximum.  Rows of a negative
// ("dropped") id are unspecified, as in the Pallas kernel and in the
// log-shift scan: nothing downstream reads them.
//
// The Pallas kernel walks row blocks in order and carries the last run's
// (id, maximum) from one grid step to the next; CUDA blocks run in no
// order, so nothing is carried.  A run is at most 2^steps rows, so row r
// depends on rows r - 2^steps + 1 .. r only: one thread per (row, 8
// channels) starts from its own row and looks back while the id stays
// equal.  Any C runs: when C is no multiple of 8 a thread takes one
// channel instead of a vector of 8.  A row of a negative id is copied through: its result is
// unspecified, and the padding of a cloud is one long run of them.  No
// shared memory, no atomics, no communication between blocks.
// The maximum is exact in any order, so the result equals the log-shift
// scan bit for bit on every row with id >= 0 (NaN propagates, as in
// torch.maximum).
//
// What bounds it on the H100: bytes (each value read and written once,
// 15.6 MB at 60 000 x 64 bf16) - about as long as a launch takes.  A
// warp reads 16-byte (bf16) or 32-byte (fp32) vectors of consecutive
// channels, and the look-back rows are the ones the neighbouring threads
// have just fetched, so they come from L1 / L2; device memory sees each
// row once.
#include "numeric.cuh"

namespace {

__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
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
__global__ void segmented_max_scan_kernel(const T* __restrict__ vals,
                                          const int* __restrict__ ids,
                                          T* __restrict__ out, int p, int c,
                                          int window) {
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
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = max_nan(acc[e], v[e]);
  }
  if constexpr (V == 1) {
    out[idx] = hm::from_f<T>(acc[0]);
  } else {
    hm::store_vec<T, V>(out + idx * V, acc);
  }
}

template <typename T, int V>
int launch(const void* vals, const void* ids, void* out, int p, int c,
           int window, cudaStream_t s) {
  const long long total = (long long)p * (c / V);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  segmented_max_scan_kernel<T, V><<<blocks, threads, 0, s>>>(
      static_cast<const T*>(vals), static_cast<const int*>(ids),
      static_cast<T*>(out), p, c, window);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any_c(const void* vals, const void* ids, void* out, int p, int c,
           int window, cudaStream_t s) {
  return (c & 7) == 0 ? launch<T, 8>(vals, ids, out, p, c, window, s)
                      : launch<T, 1>(vals, ids, out, p, c, window, s);
}

}  // namespace

// vals, out (P, C); ids (P,) i32; runs of ids >= 0 are at most 2^steps
// rows.  dtype 0 = f32, 1 = bf16.
extern "C" int hm_segmented_max_scan(const void* vals, const void* ids,
                                     void* out, int dtype, int p, int c,
                                     int steps, void* stream) {
  if (c < 0 || steps < 0 || steps > 30 || p < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)p * c == 0) return 0;
  const int window = 1 << steps;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_any_c<float>(vals, ids, out, p, c, window, s);
  if (dtype == 1) {
    return launch_any_c<__nv_bfloat16>(vals, ids, out, p, c, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
