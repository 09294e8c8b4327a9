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
// it on N channels read from device or shared memory, warp_vec16() on
// the 16 bytes of one vector with its reads started first.
// tile_in_view() is the ROI tile skip of the Pallas kernels, made
// conservative: a rectangle of destination pixels it calls out of view
// gets exact zeros from the taps, so a kernel may store zeros there and
// read nothing.
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

// The 16 bytes the pair warp stores for 16 / sizeof(T) consecutive
// channels (8 bfloat16 or 4 float32): apply_taps<T, N> and the rounding
// of its result, in two steps so that a caller can start the reads of
// several vectors before any arithmetic.  fetch_taps() reads the up to
// four taps (load(pix) returns the 16 bytes at source pixel pix, from
// device memory or a cluster's shared memory); combine_taps() does the
// arithmetic: the same operations in the same order as apply_taps, so
// the same bits.
struct TapWords {
  uint4 raw[2][2];
};

template <typename Load>
__device__ __forceinline__ TapWords fetch_taps(const WarpTaps& p, Load load,
                                               int self_pix) {
  TapWords t;
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      // an identity pair reads the pixel's own vector through tap (0, 0)
      const int pix = p.flag == 1 ? (dc + dr == 0 ? self_pix : -1)
                                  : p.pix[dc][dr];
      t.raw[dc][dr] = make_uint4(0u, 0u, 0u, 0u);
      if (p.flag != 2 && pix >= 0) t.raw[dc][dr] = load(pix);
    }
  }
  return t;
}

template <typename T>
__device__ __forceinline__ uint4 combine_taps(const WarpTaps& p,
                                              const TapWords& t) {
  constexpr int N = 16 / (int)sizeof(T);
  float acc[N];
  if (p.flag != 0) {  // a copy, or zeros: widened and rounded as there
    const T* e = reinterpret_cast<const T*>(&t.raw[0][0]);
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = to_f(e[k]);
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = 0.f;
  }
#pragma unroll
  for (int dc = 0; dc < 2; ++dc) {
    if (p.flag != 0 || p.w2[dc] == 0.f) continue;
    float tmp[N];
#pragma unroll
    for (int k = 0; k < N; ++k) tmp[k] = 0.f;
#pragma unroll
    for (int dr = 0; dr < 2; ++dr) {
      if (p.pix[dc][dr] < 0) continue;
      const T* e = reinterpret_cast<const T*>(&t.raw[dc][dr]);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        tmp[k] = __fmaf_rn(p.w1[dc][dr], to_f(e[k]), tmp[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < N; ++k) {
      acc[k] = __fmaf_rn(p.w2[dc], round_to<T>(tmp[k]), acc[k]);
    }
  }
  uint4 packed;
  T* e = reinterpret_cast<T*>(&packed);
#pragma unroll
  for (int k = 0; k < N; ++k) e[k] = from_f<T>(acc[k]);
  return packed;
}

template <typename T, typename Load>
__device__ __forceinline__ uint4 warp_vec16(const WarpTaps& p, Load load,
                                            int self_pix) {
  return combine_taps<T>(p, fetch_taps(p, load, self_pix));
}

// The reads of a map in device memory: source pixels pix_stride
// elements apart from base, through the read-only cache.  32-bit offsets:
// a map holds fewer than 2^31 elements (the launchers check).
template <typename T>
struct DeviceTaps {
  const T* base;
  int pix_stride;
  __device__ __forceinline__ uint4 operator()(int pix) const {
    return __ldg(reinterpret_cast<const uint4*>(base + pix * pix_stride));
  }
};

template <typename T>
__device__ __forceinline__ uint4 warp_vec16(const WarpTaps& p, const T* base,
                                            int pix_stride, int self_pix) {
  return warp_vec16<T>(p, DeviceTaps<T>{base, pix_stride}, self_pix);
}

// Whether any pixel of the destination rectangle [x0, x0 + w) x [y0, y0 +
// h) of a pair can read a source pixel (cf: the pair's coefficient row).
// False for an invalid pair, true for an identity pair.  Otherwise the
// column coordinate is affine in (x', y'), so its extremes over the
// rectangle lie at the corners; a column tap contributes only when the
// coordinate lies in (-1, size).  The row coordinate is evaluated at the
// integer column tap c, |c - ccoord| < 1, so it lies within |v0| of the
// affine row = v0 m00 x' + (v0 m01 + v1) y' + ty_adj + v0 tx: its margin
// is 1 + |v0|.  The slack covers the fp32 rounding of the kernels'
// coordinates and of this test (a few ulps of the largest term; 1e-5 of
// their magnitude is about 80).  The Pallas kernels' test takes the row
// margin as 1 and so is not conservative.
// ops/fused_warp.py::roi_tile_valid is the same predicate in PyTorch.
__device__ __forceinline__ bool tile_in_view(const float* __restrict__ cf,
                                             int x0, int y0, int w, int h,
                                             int size) {
  const float flag = cf[7];
  if (flag > 1.5f) return false;
  if (flag > 0.5f) return true;
  const float m00 = cf[0], m01 = cf[1], tx = cf[2];
  const float v0 = cf[3], v1 = cf[4], tya = cf[5];
  const float xa = (float)x0, xb = (float)(x0 + w - 1);
  const float ya = (float)y0, yb = (float)(y0 + h - 1);
  const float rx = __fmul_rn(v0, m00);
  const float ry = __fadd_rn(__fmul_rn(v0, m01), v1);
  const float r0 = __fadd_rn(tya, __fmul_rn(v0, tx));
  const float fsize = (float)size;
  // lo / hi of cx x' + cy y' + c0 over the rectangle
  auto span = [&](float cx, float cy, float c0, float& lo, float& hi) {
    const float p = __fmul_rn(cx, xa), q = __fmul_rn(cx, xb);
    const float u = __fmul_rn(cy, ya), v = __fmul_rn(cy, yb);
    lo = __fadd_rn(__fadd_rn(fminf(p, q), fminf(u, v)), c0);
    hi = __fadd_rn(__fadd_rn(fmaxf(p, q), fmaxf(u, v)), c0);
  };
  float col_lo, col_hi, row_lo, row_hi;
  span(m00, m01, tx, col_lo, col_hi);
  span(rx, ry, r0, row_lo, row_hi);
  const float av0 = fabsf(v0);
  const float mag = __fadd_rn(
      __fmul_rn(__fadd_rn(__fadd_rn(fabsf(m00), fabsf(m01)),
                          __fadd_rn(fabsf(v1),
                                    __fmul_rn(av0, __fadd_rn(
                                        __fadd_rn(fabsf(m00), fabsf(m01)),
                                        1.f)))),
                __fadd_rn(fsize, 1.f)),
      __fadd_rn(__fadd_rn(fabsf(tx), fabsf(tya)), fabsf(__fmul_rn(v0, tx))));
  const float slack = __fadd_rn(1e-3f, __fmul_rn(1e-5f, mag));
  const float row_margin = __fadd_rn(__fadd_rn(1.f, av0), slack);
  const float col_margin = __fadd_rn(1.f, slack);
  return col_hi > -col_margin && col_lo < __fadd_rn(fsize, slack) &&
         row_hi > -row_margin &&
         row_lo < __fadd_rn(fsize, __fadd_rn(av0, slack));
}

// The Pallas kernels' unit of the skip: the 32 x 32 destination tile
// (clipped to the map) that holds pixel (x, y).
constexpr int kRoiTile = 32;
__device__ __forceinline__ bool pixel_tile_in_view(
    const float* __restrict__ cf, int x, int y, int size) {
  const int x0 = x & ~(kRoiTile - 1), y0 = y & ~(kRoiTile - 1);
  return tile_in_view(cf, x0, y0, min(kRoiTile, size - x0),
                      min(kRoiTile, size - y0), size);
}

}  // namespace hm
