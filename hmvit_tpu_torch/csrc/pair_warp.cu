// Pair warp: every sender's typed K/V map resampled into every receiver's
// BEV frame.  Two kernels with one contract and bit-identical outputs.
//
// pair_warp_kernel replaces the Pallas kernel
// hmvit_tpu/ops/fused_warp.py::_warp_kernel (pallas_pair_warp, tile
// variant).  The contract: for receiver n
// (= b * R + i) and sender j, read sender j's map in receiver n's type
// variant, src[b, rtype[n], j], and warp it with the two-pass separable
// bilinear resample of hmvit_tpu/ops/shear_warp.py:
//   pass 2 (columns): ccoord = m00 x' + m01 y' + tx
//   pass 1 (rows, on each column tap c): rcoord = v1 y' + v0 c + ty_adj
// with hat weights max(0, 1 - |coord - cell|) computed in fp32 and cast
// to the compute type, the pass-1 value rounded to the compute type
// before pass 2, taps outside [0, size) contributing zero, the source
// read transposed when the conditioning swap is set, identity pairs
// copied, and pairs with non-finite coefficients written as zeros (the
// taps live in warp_taps.cuh).
//
// What bounds it on the H100: bytes.  At the serving shapes (16 pairs of
// 128 x 128 x 512 bf16) the output alone is 134 MB and every output
// vector needs 4 source vectors; there is no reuse a tensor core could
// exploit (the Pallas kernel used the MXU only because a TPU gathers
// slowly).  The design: one thread per (pair, y', x', 8 channels), so a
// warp reads and writes 16-byte vectors of consecutive channels — fully
// coalesced — and the 4 taps of neighbouring output pixels overlap in
// L1/L2, so device memory sees each source map about once per pair.
// No shared memory, no tiles: the TPU's 32 x 32 destination tiles and
// 56 x 56 DMA windows existed to feed the MXU from VMEM.
//
// pair_warp_resident_kernel replaces the Pallas kernel
// hmvit_tpu/ops/fused_warp.py::_warp_kernel_resident
// (pallas_pair_warp(variant="resident")): each source map is fetched
// once per (receiver, sender) pair and every destination pixel reads it
// from on-chip memory.  On this card "on-chip" is the block's shared
// memory: one block owns a (pair, channel slab) of 8 bytes per pixel (4
// bf16 or 2 fp32 channels), stages that slab of the whole S x S source
// map once (S = 128: 128 KB of the 227 KB a block may use), and produces
// every destination pixel of the slab from it with the same taps.  Still
// bound by bytes, and the narrow slab costs it: device-memory reads and
// writes are 8-byte segments one pixel row of channels (C * itemsize
// bytes) apart, a quarter of a 32-byte sector each, which L2 has to
// absorb.  Identity and invalid pairs skip the staging.
#include "warp_taps.cuh"

namespace {

using hm::WarpTaps;

// coef rows (n, j, 8): m00 m01 tx v0 v1 ty_adj swap flag, where flag is
// 0 = warp, 1 = identity copy, 2 = invalid pair (zeros).
template <typename T>
__global__ void pair_warp_kernel(const T* __restrict__ src,
                                 const float* __restrict__ coef,
                                 const int* __restrict__ rtype,
                                 T* __restrict__ out, int n_pairs_recv,
                                 int nj, int ty_count, int n_recv, int size,
                                 int c) {
  const int cvecs = c >> 3;
  const long long total =
      (long long)n_pairs_recv * nj * size * size * cvecs;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  long long rest = idx;
  const int cv = (int)(rest % cvecs);
  rest /= cvecs;
  const int x = (int)(rest % size);
  rest /= size;
  const int y = (int)(rest % size);
  rest /= size;
  const int j = (int)(rest % nj);
  const int n = (int)(rest / nj);

  const float* cf = coef + ((long long)n * nj + j) * 8;
  const int b = n / n_recv;
  const T* base =
      src + (((long long)b * ty_count + rtype[n]) * nj + j) *
                (long long)size * size * c +
      cv * 8;
  const WarpTaps taps = hm::plan_taps<T>(cf, x, y, size);
  float acc[8];
  hm::apply_taps<T, 8>(taps, base, c, y * size + x, acc);
  hm::store_vec<T, 8>(out + idx * 8, acc);
}

constexpr int kResidentThreads = 512;
constexpr int kSlabBytes = 8;  // per pixel: 4 bf16 or 2 fp32 channels
constexpr int kMaxSharedBytes = 232448;  // 227 KB, a Hopper block's limit

// grid (pairs, C / slab channels); dynamic shared memory size * size * 8.
template <typename T>
__global__ void __launch_bounds__(kResidentThreads)
pair_warp_resident_kernel(const T* __restrict__ src,
                          const float* __restrict__ coef,
                          const int* __restrict__ rtype, T* __restrict__ out,
                          int nj, int ty_count, int n_recv, int size, int c) {
  constexpr int kSlab = kSlabBytes / (int)sizeof(T);
  extern __shared__ uint2 slab_words[];
  const T* slab = reinterpret_cast<const T*>(slab_words);
  const int pair = blockIdx.x;
  const int n = pair / nj, j = pair - n * nj;
  const int b = n / n_recv;
  const int npix = size * size;
  const float* cf = coef + (long long)pair * 8;
  const T* map = src +
                 (((long long)b * ty_count + rtype[n]) * nj + j) *
                     (long long)npix * c +
                 blockIdx.y * kSlab;
  T* dst = out + (long long)pair * npix * c + blockIdx.y * kSlab;
  // the flag is the pair's: uniform over the block
  const bool staged = cf[7] <= 0.5f;
  if (staged) {
    for (int p = threadIdx.x; p < npix; p += blockDim.x) {
      slab_words[p] =
          *reinterpret_cast<const uint2*>(map + (long long)p * c);
    }
    __syncthreads();
  }
  for (int p = threadIdx.x; p < npix; p += blockDim.x) {
    const int y = p / size, x = p - y * size;
    const WarpTaps taps = hm::plan_taps<T>(cf, x, y, size);
    float acc[kSlab];
    if (staged) {
      hm::apply_taps<T, kSlab>(taps, slab, kSlab, p, acc);
    } else {
      hm::apply_taps<T, kSlab>(taps, map, c, p, acc);
    }
    hm::store_vec<T, kSlab>(dst + (long long)p * c, acc);
  }
}

template <typename T>
int launch_resident(const void* src, const void* coef, const void* rtype,
                    void* out, int n_pairs_recv, int nj, int ty_count,
                    int n_recv, int size, int c, cudaStream_t s) {
  constexpr int kSlab = kSlabBytes / (int)sizeof(T);
  const size_t bytes = (size_t)size * size * kSlabBytes;
  if (bytes > (size_t)kMaxSharedBytes || c / kSlab > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      pair_warp_resident_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_pairs_recv * nj, c / kSlab);
  pair_warp_resident_kernel<T><<<grid, kResidentThreads, bytes, s>>>(
      static_cast<const T*>(src), static_cast<const float*>(coef),
      static_cast<const int*>(rtype), static_cast<T*>(out), nj, ty_count,
      n_recv, size, c);
  return (int)cudaGetLastError();
}

}  // namespace
// src (B, TY, J, S, S, C); coef (N, J, 8) f32; rtype (N,) i32;
// out (N, J, S, S, C) with N = B * n_recv.  dtype 0 = f32, 1 = bf16.
extern "C" int hm_pair_warp(const void* src, const void* coef,
                            const void* rtype, void* out, int dtype,
                            int n_pairs_recv, int nj, int ty_count,
                            int n_recv, int size, int size_w, int c,
                            void* stream) {
  if (size != size_w || (c & 7) != 0) return (int)cudaErrorInvalidValue;
  const long long total =
      (long long)n_pairs_recv * nj * size * size * (c >> 3);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    pair_warp_kernel<float><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(src), static_cast<const float*>(coef),
        static_cast<const int*>(rtype), static_cast<float*>(out),
        n_pairs_recv, nj, ty_count, n_recv, size, c);
  } else if (dtype == 1) {
    pair_warp_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(src),
        static_cast<const float*>(coef), static_cast<const int*>(rtype),
        static_cast<__nv_bfloat16*>(out), n_pairs_recv, nj, ty_count,
        n_recv, size, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The resident variant: the same arguments and the same output bits.
// size * size * 8 bytes of shared memory must fit a block (size <= 170).
extern "C" int hm_pair_warp_resident(const void* src, const void* coef,
                                     const void* rtype, void* out, int dtype,
                                     int n_pairs_recv, int nj, int ty_count,
                                     int n_recv, int size, int size_w, int c,
                                     void* stream) {
  if (size != size_w || (c & 7) != 0) return (int)cudaErrorInvalidValue;
  if ((long long)n_pairs_recv * nj * size * c == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_resident<float>(src, coef, rtype, out, n_pairs_recv, nj,
                                  ty_count, n_recv, size, c, s);
  }
  if (dtype == 1) {
    return launch_resident<__nv_bfloat16>(src, coef, rtype, out,
                                          n_pairs_recv, nj, ty_count, n_recv,
                                          size, c, s);
  }
  return (int)cudaErrorInvalidValue;
}
