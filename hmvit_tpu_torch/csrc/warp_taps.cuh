// The taps of the two-pass separable bilinear BEV warp, shared by the
// pair-warp kernels (tile and resident) and the fused warp + attention
// kernel, so that all three produce the same bits.
//
// One destination pixel (x', y') of a (receiver, sender) pair reads up
// to 2 x 2 source pixels (hmvit_tpu/ops/shear_warp.py):
//   pass 2 (columns): ccoord = m00 x' + m01 y' + tx
//   pass 1 (rows, on each column tap c): rcoord = v1 y' + v0 c + ty_adj
// with hat weights max(0, 1 - |coord - cell|) computed in fp32 and
// rounded to the compute type, the pass-1 value rounded to the compute
// type before pass 2, taps outside [0, size) contributing zero, the
// source read transposed when the conditioning swap is set, identity
// pairs copied, and pairs with non-finite coefficients giving zeros.
// plan_taps() works the geometry out once per pixel; apply_taps() runs
// it on N channels read from device or shared memory.
#pragma once
#include "numeric.cuh"

namespace hm {

struct WarpTaps {
  int pix[2][2];   // [column tap][row tap] source pixel h * size + w;
                   // -1: the tap contributes nothing
  float w1[2][2];  // pass-1 (row) weights, rounded to the compute type
  float w2[2];     // pass-2 (column) weights; 0: the column tap is skipped
  int flag;        // 0 = warp, 1 = identity copy, 2 = invalid pair (zeros)
};

__device__ __forceinline__ float hat(float coord, float cell) {
  return fmaxf(0.f, 1.f - fabsf(coord - cell));
}

// cf: one coefficient row [m00 m01 tx v0 v1 ty_adj swap flag].
template <typename T>
__device__ __forceinline__ WarpTaps plan_taps(const float* __restrict__ cf,
                                              int x, int y, int size) {
  WarpTaps p;
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
    p.w2[dc] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      p.pix[dc][dr] = -1;
      p.w1[dc][dr] = 0.f;
    }
  }
  const float flag = cf[7];
  p.flag = flag > 1.5f ? 2 : (flag > 0.5f ? 1 : 0);
  if (p.flag != 0) return p;
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
    const float w2 = round_to<T>(hat(cc, ccell));
    if (w2 == 0.f || ccell < 0.f || ccell >= fsize) continue;
    p.w2[dc] = w2;
    const int ci = (int)ccell;
    const float rc =
        __fadd_rn(__fadd_rn(__fmul_rn(v1, yf), __fmul_rn(v0, ccell)), tya);
    const float r0 = floorf(rc);
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      const float rcell = r0 + (float)dr;
      const float w1 = round_to<T>(hat(rc, rcell));
      if (w1 == 0.f || rcell < 0.f || rcell >= fsize) continue;
      const int ri = (int)rcell;
      // src_in[row, col] is the map transposed when swapped
      p.w1[dc][dr] = w1;
      p.pix[dc][dr] = swap ? ci * size + ri : ri * size + ci;
    }
  }
  return p;
}

// acc[N] = the warped value of N consecutive channels.  base points at
// channel 0 of those N in source pixel 0; pixels lie pix_stride elements
// apart; self_pix is the destination pixel's own index (identity pairs).
// Explicit fused multiply-adds: every caller rounds at the same places.
template <typename T, int N>
__device__ __forceinline__ void apply_taps(const WarpTaps& p, const T* base,
                                           int pix_stride, int self_pix,
                                           float acc[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0.f;
  if (p.flag == 2) return;
  if (p.flag == 1) {
    load_vec<T, N>(base + (long long)self_pix * pix_stride, acc);
    return;
  }
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
    if (p.w2[dc] == 0.f) continue;
    float tmp[N];
#pragma unroll
    for (int k = 0; k < N; ++k) tmp[k] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      if (p.pix[dc][dr] < 0) continue;
      float v[N];
      load_vec<T, N>(base + (long long)p.pix[dc][dr] * pix_stride, v);
#pragma unroll
      for (int k = 0; k < N; ++k) tmp[k] = __fmaf_rn(p.w1[dc][dr], v[k], tmp[k]);
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      acc[k] = __fmaf_rn(p.w2[dc], round_to<T>(tmp[k]), acc[k]);
    }
  }
}

// The 16 bytes the pair warp stores for 8 consecutive bfloat16 channels:
// apply_taps<__nv_bfloat16, 8> and the rounding of its result, with the
// up to four 16-byte reads started before any arithmetic, so that they
// are in flight together.  The same operations in the same order as
// apply_taps: the same bits.
__device__ __forceinline__ uint4 warp_vector_bf16(const WarpTaps& p,
                                                  const __nv_bfloat16* base,
                                                  int pix_stride,
                                                  int self_pix) {
  typedef __nv_bfloat16 T;
  uint4 raw[2][2];
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      // an identity pair reads the pixel's own vector through tap (0, 0)
      const int pix = p.flag == 1 ? (dc + dr == 0 ? self_pix : -1)
                                  : p.pix[dc][dr];
      raw[dc][dr] = make_uint4(0u, 0u, 0u, 0u);
      if (p.flag != 2 && pix >= 0) {
        raw[dc][dr] = __ldg(reinterpret_cast<const uint4*>(
            base + (long long)pix * pix_stride));
      }
    }
  }
  float acc[8];
  if (p.flag != 0) {  // a copy, or zeros: widened and rounded as there
    const T* e = reinterpret_cast<const T*>(&raw[0][0]);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = to_f(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  }
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
    if (p.flag != 0 || p.w2[dc] == 0.f) continue;
    float tmp[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) tmp[k] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      if (p.pix[dc][dr] < 0) continue;
      const T* e = reinterpret_cast<const T*>(&raw[dc][dr]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        tmp[k] = __fmaf_rn(p.w1[dc][dr], to_f(e[k]), tmp[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      acc[k] = __fmaf_rn(p.w2[dc], round_to<T>(tmp[k]), acc[k]);
    }
  }
  uint4 packed;
  T* e = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int k = 0; k < 8; ++k) e[k] = from_f<T>(acc[k]);
  return packed;
}

}  // namespace hm
