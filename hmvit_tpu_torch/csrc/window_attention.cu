// Multi-sender window attention, two index maps of one kernel body.
//
// Replaces two Pallas kernels of hmvit_tpu/ops/window_attention.py:
//   * STRIPE = true:  _stripe_kernel (stripe_window_attention) — local
//     8 x 8 windows read straight from (N, H, W, C) / (N, J, H, W, 2C):
//     window (wy, wx), token (ty, tx) is pixel (wy*win + ty, wx*win + tx);
//   * STRIPE = false: _plain_kernel (plain_window_attention) — windows
//     already split, (N, Wn, T, C) / (N, J, Wn, T, 2C).
// Per window and head: sim = q . k over all J*T keys (q arrives scaled),
// where(mask > 0, sim + bias[h, t, s mod T], -1e9), softmax over the
// J*T keys, a row whose max is <= -5e8 outputs 0, out = attn . v.  All
// math in fp32, whatever the storage type.
//
// What bounds it on the H100: at the serving shapes (T = 64, d = 32,
// J = 4, 8 heads) the work is 2 * 64 * 256 * 32 multiply-adds per
// window and head — small matrices the TPU ran on the MXU.  This first
// version runs them on the fp32 CUDA cores, so it is bound by
// shared-memory bandwidth and fp32 issue rate, not by device memory
// (each q/k/v element is read once).  The design: one block per
// (n, window), looping over heads; q_h, K_h, V_h of all J senders are
// staged in fp32 shared memory (K rows padded to d+1 floats so the 32
// lanes of a warp read 32 different banks); one warp owns 4 query rows
// at a time, so each K or V value read from shared memory feeds 4
// multiply-adds (q is read as broadcast float4s): each lane scores 1/32
// of the keys, the softmax reduces with warp shuffles, and each lane
// accumulates one output channel per row (d <= 64 channels per head, 32
// per lane pass).  No intermediate leaves the block.  Tensor cores
// (mma.sync / wgmma) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxKeys = 320;   // J * T (J <= 5 at T = 64)
constexpr int kKeysPerLane = kMaxKeys / 32;
constexpr int kMaxD = 64;
constexpr int kDPerLane = kMaxD / 32;
constexpr int kThreads = 256;
constexpr int kRows = 4;        // query rows per warp pass
static_assert(kRows == 4, "P is published as one float4 per key");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

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

size_t smem_bytes(int nk, int t, int d) {
  const int dp = d + 1;
  return sizeof(float4) * (kThreads / 32) * 32 +
         sizeof(float) * ((size_t)t * d + (size_t)nk * dp + (size_t)nk * d +
                          (size_t)t * t + (size_t)nk);
}

// grid (n_windows, N); q/out (N, S, C); kv (N, J, S, 2C); mask (N, J, S)
// f32; bias (heads, T, T) f32; S = n_windows * T tokens per map.
template <typename T, bool STRIPE>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ q, const T* __restrict__ kv,
                        const float* __restrict__ bias,
                        const float* __restrict__ mask, T* __restrict__ out,
                        int nj, int nwin, int t, int win, int wcols,
                        int heads, int d) {
  extern __shared__ float4 smem4[];
  const int wi = blockIdx.x;
  const int n = blockIdx.y;
  const int c = heads * d;
  const int nk = nj * t;
  const int dp = d + 1;
  const long long s_per_n = (long long)nwin * t;
  float4* pbuf = smem4;          // per warp: 32 keys x 4 rows of P
  float* qs = reinterpret_cast<float*>(smem4 + (kThreads / 32) * 32);
                                 // t x d (rows 16-byte aligned)
  float* ks = qs + t * d;        // nk x dp
  float* vs = ks + nk * dp;      // nk x d
  float* bs = vs + nk * d;       // t x t
  float* ms = bs + t * t;        // nk

  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const int jj = i / t, tt = i - jj * t;
    ms[i] = mask[((long long)n * nj + jj) * s_per_n +
                 token_index<STRIPE>(wi, tt, t, win, wcols)];
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  for (int hh = 0; hh < heads; ++hh) {
    __syncthreads();  // the previous head's readers are done
    for (int i = threadIdx.x; i < t * d; i += blockDim.x) {
      const int tt = i / d, dd = i - tt * d;
      const long long tok = token_index<STRIPE>(wi, tt, t, win, wcols);
      qs[tt * d + dd] = to_f(q[((long long)n * s_per_n + tok) * c + hh * d + dd]);
    }
    for (int i = threadIdx.x; i < nk * d; i += blockDim.x) {
      const int s = i / d, dd = i - s * d;
      const int jj = s / t, tt = s - jj * t;
      const long long tok = token_index<STRIPE>(wi, tt, t, win, wcols);
      const T* row = kv + (((long long)n * nj + jj) * s_per_n + tok) * (2LL * c);
      ks[s * dp + dd] = to_f(row[hh * d + dd]);
      vs[s * d + dd] = to_f(row[c + hh * d + dd]);
    }
    for (int i = threadIdx.x; i < t * t; i += blockDim.x) {
      bs[i] = bias[(long long)hh * t * t + i];
    }
    __syncthreads();

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
          for (int k = 0; k < d; k += 4) {
            const float k0 = krow[k], k1 = krow[k + 1];
            const float k2 = krow[k + 2], k3 = krow[k + 3];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              // the same q address in every lane: a broadcast read
              const float4 qv =
                  *reinterpret_cast<const float4*>(qs + (t0 + r) * d + k);
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
        T* orow = out + ((long long)n * s_per_n + tok) * c + hh * d;
#pragma unroll
        for (int k = 0; k < kDPerLane; ++k) {
          const int dd = lane + 32 * k;
          if (dd < d) orow[dd] = from_f<T>(acc[r][k]);
        }
      }
    }
  }
}

template <typename T, bool STRIPE>
int launch(const void* q, const void* kv, const void* bias, const void* mask,
           void* out, int n, int nj, int nwin, int t, int win, int wcols,
           int heads, int d, cudaStream_t stream) {
  const int nk = nj * t;
  if (nk > kMaxKeys || d > kMaxD || d <= 0 || d % 4 != 0 || t <= 0 ||
      t % kRows != 0 || nj <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || nwin == 0) return 0;
  const size_t bytes = smem_bytes(nk, t, d);
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_kernel<T, STRIPE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nwin, n);
  window_attention_kernel<T, STRIPE><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kv),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<T*>(out), nj, nwin, t, win, wcols, heads, d);
  return (int)cudaGetLastError();
}

template <bool STRIPE>
int dispatch(const void* q, const void* kv, const void* bias,
             const void* mask, void* out, int dtype, int n, int nj, int nwin,
             int t, int win, int wcols, int heads, int d, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float, STRIPE>(q, kv, bias, mask, out, n, nj, nwin, t, win,
                                 wcols, heads, d, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16, STRIPE>(q, kv, bias, mask, out, n, nj, nwin,
                                         t, win, wcols, heads, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q/out (N, H, W, C), kv (N, J, H, W, 2C), mask (N, J, H, W) f32,
// bias (heads, T, T) f32; windows win x win, nwin = (H/win) * (W/win),
// wcols = W / win.  dtype 0 = f32, 1 = bf16.
extern "C" int hm_stripe_window_attention(const void* q, const void* kv,
                                          const void* bias, const void* mask,
                                          void* out, int dtype, int n, int nj,
                                          int nwin, int t, int win, int wcols,
                                          int heads, int d, void* stream) {
  if (win * win != t) return (int)cudaErrorInvalidValue;
  return dispatch<true>(q, kv, bias, mask, out, dtype, n, nj, nwin, t, win,
                        wcols, heads, d, stream);
}

// q/out (N, Wn, T, C), kv (N, J, Wn, T, 2C), mask (N, J, Wn, T) f32,
// bias (heads, T, T) f32.  win and wcols are unused.
extern "C" int hm_plain_window_attention(const void* q, const void* kv,
                                         const void* bias, const void* mask,
                                         void* out, int dtype, int n, int nj,
                                         int nwin, int t, int win, int wcols,
                                         int heads, int d, void* stream) {
  return dispatch<false>(q, kv, bias, mask, out, dtype, n, nj, nwin, t, win,
                         wcols, heads, d, stream);
}
