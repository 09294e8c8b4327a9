// Pair warp: every sender's typed K/V map resampled into every receiver's
// BEV frame.
//
// Replaces the Pallas kernel hmvit_tpu/ops/fused_warp.py::_warp_kernel
// (pallas_pair_warp, tile variant).  Same contract: for receiver n
// (= b * R + i) and sender j, read sender j's map in receiver n's type
// variant, src[b, rtype[n], j], and warp it with the two-pass separable
// bilinear resample of hmvit_tpu/ops/shear_warp.py:
//   pass 2 (columns): ccoord = m00 x' + m01 y' + tx
//   pass 1 (rows, on each column tap c): rcoord = v1 y' + v0 c + ty_adj
// with hat weights max(0, 1 - |coord - cell|) computed in fp32 and cast
// to the compute type, the pass-1 value rounded to the compute type
// before pass 2, taps outside [0, size) contributing zero, the source
// read transposed when the conditioning swap is set, identity pairs
// copied, and pairs with non-finite coefficients written as zeros.
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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
struct Vec8;

template <>
struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float v[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float v[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h2[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float v[8]) {
    uint4 raw;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

__device__ __forceinline__ float hat(float coord, float cell) {
  return fmaxf(0.f, 1.f - fabsf(coord - cell));
}

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
  T* dst = out + idx * 8;

  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  const float flag = cf[7];
  if (flag > 1.5f) {
    Vec8<T>::store(dst, acc);
    return;
  }
  if (flag > 0.5f) {
    float v[8];
    Vec8<T>::load(base + ((long long)y * size + x) * c, v);
    Vec8<T>::store(dst, v);
    return;
  }
  const float m00 = cf[0], m01 = cf[1], tx = cf[2];
  const float v0 = cf[3], v1 = cf[4], tya = cf[5];
  const bool swap = cf[6] > 0.5f;
  const float xf = (float)x, yf = (float)y;
  const float fsize = (float)size;
  // explicit rounding steps: the same fp32 operation order as the JAX
  // coordinate math, with no fused multiply-add contraction
  const float cc =
      __fadd_rn(__fadd_rn(__fmul_rn(m00, xf), __fmul_rn(m01, yf)), tx);
  const float c0 = floorf(cc);
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
    const float ccell = c0 + (float)dc;
    const float w2 = Vec8<T>::round(hat(cc, ccell));
    if (w2 == 0.f || ccell < 0.f || ccell >= fsize) continue;
    const int ci = (int)ccell;
    const float rc =
        __fadd_rn(__fadd_rn(__fmul_rn(v1, yf), __fmul_rn(v0, ccell)), tya);
    const float r0 = floorf(rc);
    float tmp[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) tmp[k] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      const float rcell = r0 + (float)dr;
      const float w1 = Vec8<T>::round(hat(rc, rcell));
      if (w1 == 0.f || rcell < 0.f || rcell >= fsize) continue;
      const int ri = (int)rcell;
      // src_in[row, col] is the map transposed when swapped
      const int hh = swap ? ci : ri;
      const int ww = swap ? ri : ci;
      float v[8];
      Vec8<T>::load(base + ((long long)hh * size + ww) * c, v);
#pragma unroll
      for (int k = 0; k < 8; ++k) tmp[k] += w1 * v[k];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += w2 * Vec8<T>::round(tmp[k]);
  }
  Vec8<T>::store(dst, acc);
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
