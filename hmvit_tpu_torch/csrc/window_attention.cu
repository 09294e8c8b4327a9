// Multi-sender window attention: the C entry points of the stripe, plain
// and typed kernels, and their fp32 CUDA-core form over one attention
// body (attention_body.cuh).
//
// hm_stripe_window_attention, hm_plain_window_attention and
// hm_typed_window_attention choose inside, by type and shape (as does
// hm_warp_window_attention of fused_warp_attention.cu, by the same
// rule): bfloat16 operands with T % 16 == 0, T <= 128,
// d % 16 == 0, d <= 64, J*T <= 320 and 16-byte aligned pointers (the
// serving path) go to the tensor-core kernels of
// window_attention_mma.cu, whose header says what bounds them (bytes)
// and how they are laid out; float32 — the
// check lane, held to the twins at 1e-4 — and every other shape within
// J*T <= 320, d <= 64, d % 4 == 0, T % 4 == 0 run the kernels below.
// Nothing falls from one to the other on a failure.  The *_simt entry
// points always run the kernels below (for timing the two side by side).
//
// window_attention_kernel replaces two Pallas kernels of
// hmvit_tpu/ops/window_attention.py:
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
// What bounds this form on the H100: the products (2 * 64 * 256 * 32
// multiply-adds per window and head at T = 64, d = 32, J = 4) run on
// the fp32 CUDA cores out of fp32 shared memory, so it is bound by
// shared-memory bandwidth and fp32 instruction rate, 7-28 times over the
// bytes it moves.  One block per (n, window), looping over heads; q_h,
// K_h, V_h of all J senders are staged in fp32 shared memory (K rows
// padded to d+1 floats so the 32 lanes of a warp read 32 different
// banks); the body then gives each warp 4 query rows at a time.  No
// intermediate leaves the block.  It is fp32 arithmetic in a fixed
// order, shared with the fused warp + attention kernel's fp32 form, so
// that the two agree bit for bit (as their tensor-core forms do).
//
// typed_window_attention_kernel replaces the Pallas kernel
// hmvit_tpu/ops/window_attention.py::_kernel (hetero_window_attention):
// per pair (n, j) and head, sim = (q_h W_att[n, j, h]) k_j^T + bias,
// the same mask, softmax over the J*T keys and zero rows, and
// out = sum_j attn_j (v_j W_msg[n, j, h]^T), on pre-split windows with
// K and V as separate tensors.  Per head the block also stages the J
// pairs of d x d relation matrices (rows padded to d + 1 floats) and
// computes, in fp32 shared memory, the J relation-transformed query
// blocks q_h W_att[j] and the transformed values v W_msg[j]^T before it
// enters the body — the raw values' buffer is reused for the
// transformed queries.  At J = 5, T = 64, d = 32 that is 194 KB of the
// 227 KB a block may use: one block per SM.
#include <stdint.h>

#include "attention_body.cuh"
#include "window_attention_mma.cuh"

namespace {

using hm::kPBufFloat4;
using hm::kThreads;
using hm::to_f;
using hm::token_index;

// A head's t x t bias is staged in shared memory up to T = 128 (64 KB).
// A longer window (V2X-ViT's 16 x 16: T = 256, 256 KB a head, more than a
// block may hold) is read from device memory by the body, the same values
// from another place (L1 / L2 serve a block's repeated reads).
constexpr int kMaxStagedBiasT = 128;

size_t smem_bytes(int nk, int t, int d) {
  const int dp = d + 1;
  const size_t tb = t <= kMaxStagedBiasT ? (size_t)t * t : 0;
  return sizeof(float4) * kPBufFloat4 +
         sizeof(float) * ((size_t)t * d + (size_t)nk * dp + (size_t)nk * d +
                          tb + (size_t)nk);
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
  const bool stage_bias = t <= kMaxStagedBiasT;
  float4* pbuf = smem4;          // per warp: 32 keys x 4 rows of P
  float* qs = reinterpret_cast<float*>(smem4 + kPBufFloat4);
                                 // t x d (rows 16-byte aligned)
  float* ks = qs + t * d;        // nk x dp
  float* vs = ks + nk * dp;      // nk x d
  float* bs = vs + nk * d;       // t x t when staged
  float* ms = bs + (stage_bias ? t * t : 0);  // nk

  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const int jj = i / t, tt = i - jj * t;
    ms[i] = mask[((long long)n * nj + jj) * s_per_n +
                 token_index<STRIPE>(wi, tt, t, win, wcols)];
  }

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
    const float* bias_h = bias + (long long)hh * t * t;
    if (stage_bias) {
      for (int i = threadIdx.x; i < t * t; i += blockDim.x) bs[i] = bias_h[i];
    }
    __syncthreads();
    hm::attend_head<T, STRIPE, false>(
        qs, ks, vs, stage_bias ? bs : bias_h, ms, pbuf,
        out + (long long)n * s_per_n * c + hh * d, wi, nk, t, d, c, win,
        wcols);
  }
}

size_t typed_smem_bytes(int nj, int t, int d) {
  const int dp = d + 1;
  const size_t nk = (size_t)nj * t;
  return sizeof(float4) * kPBufFloat4 +
         sizeof(float) * ((size_t)t * d + nk * d + nk * dp + nk * d +
                          (size_t)t * t + nk + 2 * (size_t)nj * d * dp);
}

// grid (n_windows, N); q/out (N, Wn, T, C); k, v (N, J, Wn, T, C);
// w_att, w_msg (N, J, heads, d, d) in the storage type; bias (heads, T,
// T) f32; mask (N, J, Wn, T) f32.
template <typename T>
__global__ void __launch_bounds__(kThreads)
typed_window_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              const T* __restrict__ w_att,
                              const T* __restrict__ w_msg,
                              const float* __restrict__ bias,
                              const float* __restrict__ mask,
                              T* __restrict__ out, int nj, int nwin, int t,
                              int heads, int d) {
  extern __shared__ float4 smem4[];
  const int wi = blockIdx.x;
  const int n = blockIdx.y;
  const int c = heads * d;
  const int nk = nj * t;
  const int dp = d + 1;
  const long long s_per_n = (long long)nwin * t;
  float4* pbuf = smem4;
  float* qs = reinterpret_cast<float*>(smem4 + kPBufFloat4);  // t x d
  float* xs = qs + t * d;    // nk x d: raw V, then the J blocks of q W_att
  float* ks = xs + nk * d;   // nk x dp
  float* vs = ks + nk * dp;  // nk x d: v W_msg^T
  float* bs = vs + nk * d;   // t x t
  float* ms = bs + t * t;    // nk
  float* was = ms + nk;      // J x d x dp: W_att[j][din][dout]
  float* wms = was + nj * d * dp;  // J x d x dp: W_msg[j][dout][din]

  for (int i = threadIdx.x; i < nk; i += blockDim.x) {
    const int jj = i / t, tt = i - jj * t;
    ms[i] = mask[((long long)n * nj + jj) * s_per_n + (long long)wi * t + tt];
  }

  for (int hh = 0; hh < heads; ++hh) {
    __syncthreads();  // the previous head's readers are done
    for (int i = threadIdx.x; i < t * d; i += blockDim.x) {
      const int tt = i / d, dd = i - tt * d;
      qs[i] = to_f(q[((long long)n * s_per_n + (long long)wi * t + tt) * c +
                     hh * d + dd]);
    }
    for (int i = threadIdx.x; i < nk * d; i += blockDim.x) {
      const int s = i / d, dd = i - s * d;
      const int jj = s / t, tt = s - jj * t;
      const long long at =
          ((((long long)n * nj + jj) * s_per_n + (long long)wi * t + tt) * c) +
          hh * d + dd;
      ks[s * dp + dd] = to_f(k[at]);
      xs[i] = to_f(v[at]);
    }
    for (int i = threadIdx.x; i < nj * d * d; i += blockDim.x) {
      const int jj = i / (d * d), rest = i - jj * d * d;
      const int a = rest / d, b = rest - a * d;
      const long long at =
          ((((long long)n * nj + jj) * heads + hh) * d + a) * d + b;
      was[(jj * d + a) * dp + b] = to_f(w_att[at]);
      wms[(jj * d + a) * dp + b] = to_f(w_msg[at]);
    }
    for (int i = threadIdx.x; i < t * t; i += blockDim.x) {
      bs[i] = bias[(long long)hh * t * t + i];
    }
    __syncthreads();
    // v_msg[s, a] = sum_e v[s, e] W_msg[j, a, e]
    for (int i = threadIdx.x; i < nk * d; i += blockDim.x) {
      const int s = i / d, a = i - s * d;
      const float* vrow = xs + s * d;
      const float* wrow = wms + ((s / t) * d + a) * dp;
      float acc = 0.f;
      for (int e = 0; e < d; ++e) acc += vrow[e] * wrow[e];
      vs[i] = acc;
    }
    __syncthreads();  // raw V is consumed: xs becomes the typed queries
    // qw[j, tt, e] = sum_a q[tt, a] W_att[j, a, e]
    for (int i = threadIdx.x; i < nk * d; i += blockDim.x) {
      const int s = i / d, e = i - s * d;
      const int jj = s / t, tt = s - jj * t;
      const float* qrow = qs + tt * d;
      const float* wcol = was + jj * d * dp + e;
      float acc = 0.f;
      for (int a = 0; a < d; ++a) acc += qrow[a] * wcol[a * dp];
      xs[i] = acc;
    }
    __syncthreads();
    hm::attend_head<T, false, true>(
        xs, ks, vs, bs, ms, pbuf, out + (long long)n * s_per_n * c + hh * d,
        wi, nk, t, d, c, 0, 0);
  }
}

bool bad_shape(int nj, int t, int d) {
  return nj * t > hm::kMaxKeys || d > hm::kMaxD || d <= 0 || d % 4 != 0 ||
         t <= 0 || t % hm::kRows != 0 || nj <= 0;
}

template <typename T, bool STRIPE>
int launch(const void* q, const void* kv, const void* bias, const void* mask,
           void* out, int n, int nj, int nwin, int t, int win, int wcols,
           int heads, int d, cudaStream_t stream) {
  if (bad_shape(nj, t, d)) return (int)cudaErrorInvalidValue;
  if (n == 0 || nwin == 0) return 0;
  const size_t bytes = smem_bytes(nj * t, t, d);
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

template <typename T>
int launch_typed(const void* q, const void* k, const void* v,
                 const void* w_att, const void* w_msg, const void* bias,
                 const void* mask, void* out, int n, int nj, int nwin, int t,
                 int heads, int d, cudaStream_t stream) {
  if (bad_shape(nj, t, d)) return (int)cudaErrorInvalidValue;
  if (n == 0 || nwin == 0) return 0;
  const size_t bytes = typed_smem_bytes(nj, t, d);
  cudaError_t err = cudaFuncSetAttribute(
      typed_window_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nwin, n);
  typed_window_attention_kernel<T><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w_att),
      static_cast<const T*>(w_msg), static_cast<const float*>(bias),
      static_cast<const float*>(mask), static_cast<T*>(out), nj, nwin, t,
      heads, d);
  return (int)cudaGetLastError();
}

int dispatch_typed(const void* q, const void* k, const void* v,
                   const void* w_att, const void* w_msg, const void* bias,
                   const void* mask, void* out, int dtype, int n, int nj,
                   int nwin, int t, int heads, int d, cudaStream_t s) {
  if (dtype == 0) {
    return launch_typed<float>(q, k, v, w_att, w_msg, bias, mask, out, n, nj,
                               nwin, t, heads, d, s);
  }
  if (dtype == 1) {
    return launch_typed<__nv_bfloat16>(q, k, v, w_att, w_msg, bias, mask, out,
                                       n, nj, nwin, t, heads, d, s);
  }
  return (int)cudaErrorInvalidValue;
}

// launches per kernel (0 stripe, 1 plain, 2 typed, 3 fused warp +
// attention) and body (0 fp32 CUDA cores, 1 tensor cores), counted where
// the choice is made; plain ints: launches come from one host thread at
// a time
constexpr int kKernels = 4;
int g_launches[kKernels][2];

}  // namespace

int hm::counted(int kernel, int body, int rc) {
  if (rc == 0) ++g_launches[kernel][body];
  return rc;
}

// 1 when bfloat16 (dtype 1) operands of this shape, 16-byte aligned, go
// to the tensor-core body, 0 when to the fp32 body, -1 when no kernel
// takes them
extern "C" int hm_attention_body_rule(int dtype, int nj, int t, int d) {
  if (dtype == 1 && hm::shape_takes_mma(nj, t, d)) return 1;
  return (dtype != 0 && dtype != 1) || bad_shape(nj, t, d) ? -1 : 0;
}

extern "C" int hm_attention_body_launches(int kernel, int body) {
  if (kernel < 0 || kernel >= kKernels || body < 0 || body > 1) return -1;
  return g_launches[kernel][body];
}

extern "C" void hm_attention_body_reset() {
  for (auto& row : g_launches) row[0] = row[1] = 0;
}

// q/out (N, H, W, C), kv (N, J, H, W, 2C), mask (N, J, H, W) f32,
// bias (heads, T, T) f32; windows win x win, nwin = (H/win) * (W/win),
// wcols = W / win.  dtype 0 = f32, 1 = bf16.  Always the fp32 body.
extern "C" int hm_stripe_window_attention_simt(
    const void* q, const void* kv, const void* bias, const void* mask,
    void* out, int dtype, int n, int nj, int nwin, int t, int win, int wcols,
    int heads, int d, void* stream) {
  if (win <= 0 || win * win != t || wcols <= 0 || nwin % wcols != 0) {
    return (int)cudaErrorInvalidValue;
  }
  return hm::counted(0, 0,
                     dispatch<true>(q, kv, bias, mask, out, dtype, n, nj, nwin,
                                    t, win, wcols, heads, d, stream));
}

// The same operands; the body by type and shape.
extern "C" int hm_stripe_window_attention(const void* q, const void* kv,
                                          const void* bias, const void* mask,
                                          void* out, int dtype, int n, int nj,
                                          int nwin, int t, int win, int wcols,
                                          int heads, int d, void* stream) {
  if (win > 0 && win * win == t && wcols > 0 &&
      hm_attention_body_rule(dtype, nj, t, d) == 1 &&
      hm::aligned16(q, kv, bias, mask, out)) {
    const long long c = (long long)heads * d;
    return hm::counted(0, 1, hm::launch_window_attention_mma(
        q, kv, static_cast<const __nv_bfloat16*>(kv) + c, 2 * c, nullptr,
        nullptr, bias, mask, out, n, nj, nwin, t, wcols, heads, d,
        reinterpret_cast<cudaStream_t>(stream)));
  }
  return hm_stripe_window_attention_simt(q, kv, bias, mask, out, dtype, n, nj,
                                         nwin, t, win, wcols, heads, d,
                                         stream);
}

// q/out (N, Wn, T, C), kv (N, J, Wn, T, 2C), mask (N, J, Wn, T) f32,
// bias (heads, T, T) f32.  win and wcols are unused.  Always the fp32
// body.
extern "C" int hm_plain_window_attention_simt(
    const void* q, const void* kv, const void* bias, const void* mask,
    void* out, int dtype, int n, int nj, int nwin, int t, int win, int wcols,
    int heads, int d, void* stream) {
  return hm::counted(1, 0,
                     dispatch<false>(q, kv, bias, mask, out, dtype, n, nj,
                                     nwin, t, win, wcols, heads, d, stream));
}

// The same operands; the body by type and shape.
extern "C" int hm_plain_window_attention(const void* q, const void* kv,
                                         const void* bias, const void* mask,
                                         void* out, int dtype, int n, int nj,
                                         int nwin, int t, int win, int wcols,
                                         int heads, int d, void* stream) {
  if (hm_attention_body_rule(dtype, nj, t, d) == 1 &&
      hm::aligned16(q, kv, bias, mask, out)) {
    const long long c = (long long)heads * d;
    return hm::counted(1, 1, hm::launch_window_attention_mma(
        q, kv, static_cast<const __nv_bfloat16*>(kv) + c, 2 * c, nullptr,
        nullptr, bias, mask, out, n, nj, nwin, t, 0, heads, d,
        reinterpret_cast<cudaStream_t>(stream)));
  }
  return hm_plain_window_attention_simt(q, kv, bias, mask, out, dtype, n, nj,
                                        nwin, t, win, wcols, heads, d,
                                        stream);
}

// q/out (N, Wn, T, C); k, v (N, J, Wn, T, C); w_att, w_msg (N, J, heads,
// d, d); bias (heads, T, T) f32; mask (N, J, Wn, T) f32.  Always the
// fp32 body.
extern "C" int hm_typed_window_attention_simt(
    const void* q, const void* k, const void* v, const void* w_att,
    const void* w_msg, const void* bias, const void* mask, void* out,
    int dtype, int n, int nj, int nwin, int t, int heads, int d,
    void* stream) {
  return hm::counted(2, 0, dispatch_typed(
      q, k, v, w_att, w_msg, bias, mask, out, dtype, n, nj, nwin, t, heads, d,
      reinterpret_cast<cudaStream_t>(stream)));
}

// The same operands; the body by type and shape.
extern "C" int hm_typed_window_attention(const void* q, const void* k,
                                         const void* v, const void* w_att,
                                         const void* w_msg, const void* bias,
                                         const void* mask, void* out,
                                         int dtype, int n, int nj, int nwin,
                                         int t, int heads, int d,
                                         void* stream) {
  if (hm_attention_body_rule(dtype, nj, t, d) == 1 &&
      hm::aligned16(q, k, v, w_att, w_msg, bias, mask, out)) {
    return hm::counted(2, 1, hm::launch_window_attention_mma(
        q, k, v, (long long)heads * d, w_att, w_msg, bias, mask, out, n, nj,
        nwin, t, 0, heads, d, reinterpret_cast<cudaStream_t>(stream)));
  }
  return hm_typed_window_attention_simt(q, k, v, w_att, w_msg, bias, mask,
                                        out, dtype, n, nj, nwin, t, heads, d,
                                        stream);
}
