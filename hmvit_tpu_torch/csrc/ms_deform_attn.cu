// Multi-scale deformable attention, forward: mmcv's
// MultiScaleDeformableAttnFunction contract, in one pass.
//
//   out[b, q, h, :] = sum over levels l and points p of
//       a[b, q, h, l, p] * bilinear(level l of value[b, :, h, :],
//                                   loc[b, q, h, l, p])
//
// value (B, K, H, D) with K = sum of h_l * w_l (each level's map row-major
// from its start row); loc (B, Q, H, L, P, 2) float32 as (x, y) in [0, 1],
// grid_sample's align_corners=False convention (the pixel x * w - 0.5,
// y * h - 0.5, pixel i's centre at i); a (B, Q, H, L, P); out (B, Q, H D)
// in the value's type.  A tap outside its level's map reads 0
// (padding_mode="zeros").
//
// The JAX package has no Pallas kernel here (XLA gathers), so this is the
// port's own kernel; its plain twin is
// hmvit_tpu_torch/ops/sampling.py::ms_deform_attn_xla.  The twin writes
// every intermediate to device memory: per corner an index, a gather
// expanded to (B H, Q P, D), a fill and a select, then three lerps, a
// stack over levels, a permute and a batched gemv.  At the BEVFormer
// twin's spatial cross-attention (B H = 64, Q P = 131072, D = 32) each of
// those is 1.07 GB in float32.  Here nothing intermediate leaves the chip:
// the kernel reads the locations, the weights and the value taps and
// writes the output once.
//
// Design, for the H100:
//   * one warp per (b, q, h) row, one lane per channel (D = 32 at every
//     launch of the BEVFormer twin; a larger D loops over 32-channel
//     chunks, a smaller one leaves lanes idle).  Blocks of 8 warps take 8
//     consecutive rows of one batch row b (blockIdx.y), at H = 8 the 8
//     heads of one query: the block's reads of locations and weights and
//     its write of the query's H D outputs are contiguous.
//   * the point's plan is made once, not once a lane: lane i of the warp
//     computes point i of a round of up to 32 (its pixel, the floor, wx,
//     wy, which of the 4 taps lie in the map, the corner's offset, its
//     weight) into the warp's slot of shared memory, and every lane reads
//     the plans back as broadcasts.  That took the cross-attention launch
//     from 1.04 to 0.71 ms on an H100 against every lane computing every
//     point from locations broadcast by __shfl_sync; walking runs of
//     consecutive queries a block (for L1 reuse) and issuing the taps of
//     4 points at once from clamped addresses changed nothing or lost.
//   * a corner reads value[b, k, h, c0 .. c0 + 31]: one 128-byte line in
//     float32 (64 bytes in bfloat16) a warp, nothing for a tap outside
//     the map (the cross-attention's whole value, 2 MB, stays in L2).
//   * the arithmetic is the float32 twin's, step for step, each rounded
//     as the twin's separate elementwise kernels round it (no contraction
//     into FMA): px = x * w - 0.5, x0 = floor(px), wx = px - x0, corner
//     c = tap or 0, top = c00 (1 - wx) + c01 wx, bottom likewise, sample
//     = top (1 - wy) + bottom wy; the weighted sum over (l, p) is an FMA
//     chain in point order (the twin's gemv sums in its own order, so the
//     two agree to rounding, not bit for bit).  bfloat16 value and
//     weights are read as floats and the sum kept in float32: the
//     output's one rounding is to the value's type.
//   * a tap's validity is decided on the floored float (0 <= x0 < w), so
//     no integer overflows whatever the location; NaN reads no tap.
//   * no atomics: each output element is written by one lane.  Offsets
//     inside one batch row are 32-bit (K H D and Q H < 2^31, checked),
//     the batch row's own 64-bit.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "numeric.cuh"

namespace {

constexpr int kMaxLevels = 4;
constexpr int kWarps = 8;  // rows a block

struct Levels {
  int h[kMaxLevels], w[kMaxLevels], start[kMaxLevels];
};

// One point of a row, planned by one lane for the whole warp.
struct Plan {
  int o00;  // offset of the tap (x0, y0) from the level's first, elements
  int in;   // bit k: tap k of (x0, y0), (x1, y0), (x0, y1), (x1, y1) is in
  float wx, wy, a;
};

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    ms_deform_attn_kernel(const T* __restrict__ value,
                          const float* __restrict__ loc,
                          const T* __restrict__ attw, T* __restrict__ out,
                          int q_heads, int heads, int keys, int d,
                          int levels, int points, Levels lv) {
  __shared__ Plan plans_of[kWarps][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + warp;  // (q, h) inside batch row b
  if (r >= q_heads) return;  // the whole warp
  Plan* plans = plans_of[warp];
  const long long row = (long long)blockIdx.y * q_heads + r;
  const int h = r % heads;
  const int lp = levels * points;
  const float* lrow = loc + row * lp * 2;
  const T* arow = attw + row * lp;
  const int kstride = heads * d;  // elements between value rows
  const T* vrow =
      value + (long long)blockIdx.y * keys * kstride + (long long)h * d;
  T* orow = out + row * d;
  for (int c0 = 0; c0 < d; c0 += 32) {
    const bool active = c0 + lane < d;
    const T* vc = vrow + (active ? c0 + lane : 0);
    float acc = 0.f;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {
      if (l >= levels) break;
      const int ww = lv.w[l];
      const float fh = (float)lv.h[l], fw = (float)ww;
      const T* vl = vc + lv.start[l] * kstride;
      const int o01 = kstride, o10 = ww * kstride, o11 = (ww + 1) * kstride;
      for (int p0 = 0; p0 < points; p0 += 32) {
        const int n = min(32, points - p0);
        const int first = l * points + p0;
        __syncwarp();  // the previous round's plans are read
        if (lane < n) {
          const float x = lrow[2 * (first + lane)];
          const float y = lrow[2 * (first + lane) + 1];
          const float px = __fsub_rn(__fmul_rn(x, fw), 0.5f);
          const float py = __fsub_rn(__fmul_rn(y, fh), 0.5f);
          const float fx = floorf(px), fy = floorf(py);
          const bool x0in = fx >= 0.f && fx < fw;
          const bool x1in = fx >= -1.f && fx < fw - 1.f;
          const bool y0in = fy >= 0.f && fy < fh;
          const bool y1in = fy >= -1.f && fy < fh - 1.f;
          // the corner's offset, only formed when some tap is in
          const int x0 = (x0in || x1in) ? (int)fx : 0;
          const int y0 = (y0in || y1in) ? (int)fy : 0;
          Plan pl;
          pl.o00 = (y0 * ww + x0) * kstride;
          pl.in = (y0in && x0in) | (y0in && x1in) << 1 |
                  (y1in && x0in) << 2 | (y1in && x1in) << 3;
          pl.wx = __fsub_rn(px, fx);
          pl.wy = __fsub_rn(py, fy);
          pl.a = hm::to_f(arow[first + lane]);
          plans[lane] = pl;
        }
        __syncwarp();
#pragma unroll 4
        for (int i = 0; i < n; ++i) {
          const Plan pl = plans[i];
          float c00 = 0.f, c01 = 0.f, c10 = 0.f, c11 = 0.f;
          const T* v = vl + pl.o00;
          if (active) {
            if (pl.in & 1) c00 = hm::to_f(v[0]);
            if (pl.in & 2) c01 = hm::to_f(v[o01]);
            if (pl.in & 4) c10 = hm::to_f(v[o10]);
            if (pl.in & 8) c11 = hm::to_f(v[o11]);
          }
          const float ax = __fsub_rn(1.f, pl.wx), ay = __fsub_rn(1.f, pl.wy);
          const float top =
              __fadd_rn(__fmul_rn(c00, ax), __fmul_rn(c01, pl.wx));
          const float bot =
              __fadd_rn(__fmul_rn(c10, ax), __fmul_rn(c11, pl.wx));
          const float s =
              __fadd_rn(__fmul_rn(top, ay), __fmul_rn(bot, pl.wy));
          acc = fmaf(pl.a, s, acc);
        }
      }
    }
    if (active) orow[c0 + lane] = hm::from_f<T>(acc);
  }
}

template <typename T>
int launch(const void* value, const void* loc, const void* attw, void* out,
           int b, int q_heads, int heads, int keys, int d, int levels,
           int points, const Levels& lv, cudaStream_t stream) {
  const dim3 grid((unsigned)(((long long)q_heads + kWarps - 1) / kWarps), b);
  ms_deform_attn_kernel<T><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(value), static_cast<const float*>(loc),
      static_cast<const T*>(attw), static_cast<T*>(out), q_heads, heads,
      keys, d, levels, points, lv);
  return (int)cudaGetLastError();
}

}  // namespace

// value (B, K, H, D), weights (B, Q, H, L, P) and out (B, Q, H D) in one
// type (dtype 0 = f32, 1 = bf16); loc (B, Q, H, L, P, 2) f32; the levels'
// (h, w) in the first L of (h0, w0) .. (h3, w3), their h w summing to K.
extern "C" int hm_ms_deform_attn(const void* value, const void* loc,
                                 const void* attw, void* out, int dtype,
                                 int b, int keys, int q, int heads, int d,
                                 int levels, int points, int h0, int w0,
                                 int h1, int w1, int h2, int w2, int h3,
                                 int w3, void* stream) {
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  if (b < 0 || q < 0 || keys < 1 || heads < 1 || d < 1 || levels < 1 ||
      levels > kMaxLevels || points < 1 ||
      (long long)keys * heads * d >= (1ll << 31) ||
      (long long)q * heads >= (1ll << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  Levels lv{};
  long long start = 0;
  for (int l = 0; l < levels; ++l) {
    if (hs[l] < 1 || ws[l] < 1) return (int)cudaErrorInvalidValue;
    lv.h[l] = hs[l];
    lv.w[l] = ws[l];
    lv.start[l] = (int)start;
    start += (long long)hs[l] * ws[l];
  }
  if (start != keys) return (int)cudaErrorInvalidValue;
  if ((long long)b * q == 0) return 0;
  if (b > 65535) return (int)cudaErrorInvalidValue;  // gridDim.y
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int q_heads = q * heads;
  if (dtype == 0) {
    return launch<float>(value, loc, attw, out, b, q_heads, heads, keys, d,
                         levels, points, lv, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(value, loc, attw, out, b, q_heads, heads,
                                 keys, d, levels, points, lv, s);
  }
  return (int)cudaErrorInvalidValue;
}
