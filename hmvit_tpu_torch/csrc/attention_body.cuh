// One head of one window of multi-sender window attention, on operands
// a block has staged in fp32 shared memory.  Shared by the untyped
// kernels (stripe and plain index maps), the typed kernel and the fused
// warp + attention kernel, which differ only in how they stage.
//
// sim = q . k over all J*T keys (q arrives scaled),
// where(mask > 0, sim + bias[t, s mod T], -1e9), softmax over the J*T
// keys, a row whose max is <= -5e8 outputs 0, out = attn . v.  All math
// in fp32.  One warp owns 4 query rows at a time, so each K or V value
// read from shared memory feeds 4 multiply-adds (q is read as broadcast
// float4s): each lane scores 1/32 of the keys, the softmax reduces with
// warp shuffles, and each lane accumulates one output channel per row
// (d <= 64 channels per head, 32 per lane pass).
#pragma once
#include <math.h>

#include "numeric.cuh"

namespace hm {

constexpr int kMaxKeys = 320;   // J * T (J <= 5 at T = 64)
constexpr int kKeysPerLane = kMaxKeys / 32;
constexpr int kMaxD = 64;
constexpr int kDPerLane = kMaxD / 32;
constexpr int kThreads = 256;
constexpr int kRows = 4;        // query rows per warp pass
static_assert(kRows == 4, "P is published as one float4 per key");
constexpr int kPBufFloat4 = (kThreads / 32) * 32;  // per warp: 32 keys x 4 rows

// flat token index within one map: spatial pixel (stripe) or w * T + t
template <bool STRIPE>
__device__ __forceinline__ long long token_index(int wi, int tt, int t,
                                                 int win, int wcols) {
  if (STRIPE) {
    const int wy = wi / wcols, wx = wi - wy * wcols;
    const int ty = tt / win, tx = tt - ty * win;
    return (long long)(wy * win + ty) * (wcols * win) + (wx * win + tx);
  }
  return (long long)wi * t + tt;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// qs: t x d queries (TYPED: J blocks of t x d, one per sender); ks: nk
// rows of d + 1 floats (the padding spreads a warp's 32 rows over 32
// banks); vs: nk x d; bs: t x t bias of this head; ms: nk mask values;
// pbuf: kPBufFloat4 float4s; out_head: this map's output at channel
// hh * d of token 0, tokens c elements apart.  Every thread of the
// block calls it, after a __syncthreads() that follows the staging.
template <typename T, bool STRIPE, bool TYPED>
__device__ __forceinline__ void attend_head(
    const float* qs, const float* ks, const float* vs, const float* bs,
    const float* ms, float4* pbuf, T* out_head, int wi, int nk, int t, int d,
    int c, int win, int wcols) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int dp = d + 1;
  // a warp owns kRows query rows per pass: every K/V value read from
  // shared memory feeds kRows multiply-adds
  for (int t0 = warp * kRows; t0 < t; t0 += nwarps * kRows) {
    float sc[kRows][kKeysPerLane];
    float mx[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) mx[r] = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int s = i * 32 + lane;
      const bool live = s < nk && ms[s] > 0.f;
      float dot[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) dot[r] = 0.f;
      if (i * 32 < nk && live) {
        const float* krow = ks + s * dp;
        // typed: sender s / t has its own relation-transformed queries
        const float* qrow = TYPED ? qs + (s / t) * t * d : qs;
        for (int k = 0; k < d; k += 4) {
          const float k0 = krow[k], k1 = krow[k + 1];
          const float k2 = krow[k + 2], k3 = krow[k + 3];
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            // the same q address in every lane (typed: in every lane
            // of one sender): a broadcast read
            const float4 qv =
                *reinterpret_cast<const float4*>(qrow + (t0 + r) * d + k);
            dot[r] += qv.x * k0;
            dot[r] += qv.y * k1;
            dot[r] += qv.z * k2;
            dot[r] += qv.w * k3;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = -INFINITY;  // padding beyond the J*T keys
        if (s < nk) v = live ? dot[r] + bs[(t0 + r) * t + (s % t)] : -1e9f;
        sc[r][i] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float m = warp_max(mx[r]);
      float den = 0.f;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        const float e = (i * 32 + lane < nk) ? expf(sc[r][i] - m) : 0.f;
        sc[r][i] = e;
        den += e;
      }
      den = warp_sum(den);
      // a fully masked row (every key at -1e9) emits zeros
      const bool dead = m <= -5e8f;
#pragma unroll
      for (int i = 0; i < kKeysPerLane; ++i) {
        sc[r][i] = dead ? 0.f : sc[r][i] / den;
      }
    }

    // P . V: each lane publishes its 32-key slice of the 4 probability
    // rows to the warp's shared buffer, then all lanes walk the keys
    float acc[kRows][kDPerLane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int k = 0; k < kDPerLane; ++k) acc[r][k] = 0.f;
    }
    float4* pw = pbuf + warp * 32;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      if (i * 32 < nk) {  // uniform across the warp
        __syncwarp();
        pw[lane] = make_float4(sc[0][i], sc[1][i], sc[2][i], sc[3][i]);
        __syncwarp();
        const int n_src = min(32, nk - i * 32);
#pragma unroll 4
        for (int src = 0; src < n_src; ++src) {
          const float4 p = pw[src];  // broadcast
          const float* vrow = vs + (i * 32 + src) * d;
#pragma unroll
          for (int k = 0; k < kDPerLane; ++k) {
            const int dd = lane + 32 * k;
            if (dd < d) {
              const float v = vrow[dd];
              acc[0][k] += p.x * v;
              acc[1][k] += p.y * v;
              acc[2][k] += p.z * v;
              acc[3][k] += p.w * v;
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const long long tok = token_index<STRIPE>(wi, t0 + r, t, win, wcols);
      T* orow = out_head + tok * c;
#pragma unroll
      for (int k = 0; k < kDPerLane; ++k) {
        const int dd = lane + 32 * k;
        if (dd < d) orow[dd] = from_f<T>(acc[r][k]);
      }
    }
  }
}

}  // namespace hm
