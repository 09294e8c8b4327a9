// Fused pair warp + local window attention: the attention output
// computed straight from the TYPED sender maps.
//
// Replaces the Pallas kernel
// hmvit_tpu/ops/fused_warp_attention.py::_fused_kernel
// (warp_window_attention).  Same contract: the result of the pair warp
// (pair_warp.cu) followed by the stripe window attention
// (window_attention.cu), bit for bit, while the warped [K|V] tensor
// (N, J, H, W, 2C) — 268 MB in bf16 at the serving shapes — is never
// written to device memory.
//
// What bounds it on the H100: the attention arithmetic on the fp32 CUDA
// cores, as in the stripe kernel; the warp adds tap reads that L1/L2
// serve (each source vector is read by up to 4 neighbouring keys).  The
// design: one block per (receiver, window) as the stripe kernel has.
// Where that kernel copies K_h / V_h of the J senders from the warped
// tensor into fp32 shared memory, this one computes each staged vector
// of 8 channels with the pair warp's own tap routine (warp_taps.cuh)
// from src[b, rtype[n], j]: 4 taps, pass 1 rounded to the storage type,
// the result rounded to the storage type — the rounding the warped
// tensor would have had in device memory — then widened to fp32.  The
// tap geometry of the window's J * T keys depends on the poses only, so
// the block works it out once, before the loop over heads, and keeps it
// in shared memory.  The attention body is the stripe kernel's
// (attention_body.cuh), so the two paths share every rounding step.
#include "attention_body.cuh"
#include "warp_taps.cuh"

namespace {

using hm::kPBufFloat4;
using hm::kThreads;
using hm::to_f;
using hm::token_index;
using hm::WarpTaps;

size_t smem_bytes(int nk, int t, int d) {
  const int dp = d + 1;
  return sizeof(float4) * kPBufFloat4 +
         sizeof(float) * ((size_t)t * d + (size_t)nk * dp + (size_t)nk * d +
                          (size_t)t * t + (size_t)nk) +
         sizeof(WarpTaps) * (size_t)nk;
}

// grid (n_windows, N); q/out (N, S, S, C); src (B, TY, J, S, S, 2C);
// coef (N, J, 8) f32; rtype (N,) i32; bias (heads, T, T) f32; mask
// (N, J, S, S) f32; N = B * n_recv; windows win x win, T = win * win.
template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_window_attention_kernel(const T* __restrict__ q,
                             const T* __restrict__ src,
                             const float* __restrict__ coef,
                             const int* __restrict__ rtype,
                             const float* __restrict__ bias,
                             const float* __restrict__ mask,
                             T* __restrict__ out, int nj, int ty_count,
                             int n_recv, int size, int win, int heads,
                             int d) {
  extern __shared__ float4 smem4[];
  const int wi = blockIdx.x;
  const int n = blockIdx.y;
  const int c = heads * d;
  const int c2 = 2 * c;
  const int t = win * win;
  const int nk = nj * t;
  const int dp = d + 1;
  const int wcols = size / win;
  const int npix = size * size;
  float4* pbuf = smem4;
  float* qs = reinterpret_cast<float*>(smem4 + kPBufFloat4);  // t x d
  float* ks = qs + t * d;        // nk x dp
  float* vs = ks + nk * dp;      // nk x d
  float* bs = vs + nk * d;       // t x t
  float* ms = bs + t * t;        // nk
  WarpTaps* taps = reinterpret_cast<WarpTaps*>(ms + nk);  // nk

  const int b = n / n_recv;
  const T* src_n =
      src + ((long long)b * ty_count + rtype[n]) * nj * (long long)npix * c2;
  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const int jj = i / t, tt = i - jj * t;
    const int pix = (int)token_index<true>(wi, tt, t, win, wcols);
    ms[i] = mask[((long long)n * nj + jj) * npix + pix];
    taps[i] = hm::plan_taps<T>(coef + ((long long)n * nj + jj) * 8,
                               pix % size, pix / size, size);
  }

  const int vecs = d >> 3;  // 8-channel vectors per head of K (and of V)
  for (int hh = 0; hh < heads; ++hh) {
    __syncthreads();  // the previous head's readers are done, taps written
    for (int i = threadIdx.x; i < t * d; i += blockDim.x) {
      const int tt = i / d, dd = i - tt * d;
      const long long tok = token_index<true>(wi, tt, t, win, wcols);
      qs[tt * d + dd] = to_f(q[((long long)n * npix + tok) * c + hh * d + dd]);
    }
    for (int i = threadIdx.x; i < nk * 2 * vecs; i += blockDim.x) {
      const int s = i / (2 * vecs), part = i - s * 2 * vecs;
      const bool is_v = part >= vecs;
      const int vec = is_v ? part - vecs : part;
      const int jj = s / t, tt = s - jj * t;
      const int pix = (int)token_index<true>(wi, tt, t, win, wcols);
      const T* base = src_n + (long long)jj * npix * c2 + (is_v ? c : 0) +
                      hh * d + vec * 8;
      float acc[8];
      hm::apply_taps<T, 8>(taps[s], base, c2, pix, acc);
      float* dst = is_v ? vs + s * d + vec * 8 : ks + s * dp + vec * 8;
#pragma unroll
      for (int k = 0; k < 8; ++k) dst[k] = hm::round_to<T>(acc[k]);
    }
    for (int i = threadIdx.x; i < t * t; i += blockDim.x) {
      bs[i] = bias[(long long)hh * t * t + i];
    }
    __syncthreads();
    hm::attend_head<T, true, false>(
        qs, ks, vs, bs, ms, pbuf, out + (long long)n * npix * c + hh * d, wi,
        nk, t, d, c, win, wcols);
  }
}

template <typename T>
int launch(const void* q, const void* src, const void* coef,
           const void* rtype, const void* bias, const void* mask, void* out,
           int n, int nj, int ty_count, int n_recv, int size, int win,
           int heads, int d, cudaStream_t stream) {
  const int t = win * win;
  if (nj * t > hm::kMaxKeys || d > hm::kMaxD || d <= 0 || d % 8 != 0 ||
      win <= 0 || t % hm::kRows != 0 || nj <= 0 || size % win != 0 ||
      n_recv <= 0 || n % n_recv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || size == 0) return 0;
  const size_t bytes = smem_bytes(nj * t, t, d);
  cudaError_t err = cudaFuncSetAttribute(
      warp_window_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((size / win) * (size / win), n);
  warp_window_attention_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(src),
      static_cast<const float*>(coef), static_cast<const int*>(rtype),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<T*>(out), nj, ty_count, n_recv, size, win, heads, d);
  return (int)cudaGetLastError();
}

}  // namespace

// q/out (N, S, S, C) with C = heads * d; src (B, TY, J, S, S, 2C) =
// typed [K | V]; coef (N, J, 8) f32 and rtype (N,) i32 as the pair warp
// takes them; bias (heads, T, T) f32; mask (N, J, S, S) f32;
// N = B * n_recv.  dtype 0 = f32, 1 = bf16.
extern "C" int hm_warp_window_attention(const void* q, const void* src,
                                        const void* coef, const void* rtype,
                                        const void* bias, const void* mask,
                                        void* out, int dtype, int n, int nj,
                                        int ty_count, int n_recv, int size,
                                        int win, int heads, int d,
                                        void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(q, src, coef, rtype, bias, mask, out, n, nj,
                         ty_count, n_recv, size, win, heads, d, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(q, src, coef, rtype, bias, mask, out, n, nj,
                                 ty_count, n_recv, size, win, heads, d, s);
  }
  return (int)cudaErrorInvalidValue;
}
