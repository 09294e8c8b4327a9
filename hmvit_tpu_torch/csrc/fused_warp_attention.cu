// Fused pair warp + local window attention: the attention output
// computed straight from the TYPED sender maps.
//
// Replaces the Pallas kernel
// hmvit_tpu/ops/fused_warp_attention.py::_fused_kernel
// (warp_window_attention).  Same contract: the result of the pair warp
// (pair_warp.cu) followed by the stripe window attention
// (window_attention.cu), bit for bit, while the warped [K|V] tensor
// (N, J, H, W, 2C) — 268 MB in bf16 at the serving shapes — is never
// written to device memory.  Both forms skip, as the Pallas kernel does,
// the keys whose 32 x 32 tile is out of the sender's view
// (hm::pixel_tile_in_view, conservative): they stage the zeros the taps
// would give and read nothing.
//
// hm_warp_window_attention chooses inside, by the rule of the window
// attention entry points (hm_attention_body_rule): bfloat16 operands with
// T % 16 == 0, T <= 128, d % 16 == 0, d <= 64, J*T <= 320 and 16-byte
// aligned pointers (the serving path) run on the tensor cores — the
// kernel of window_attention_mma_kernel.cuh with kWarp as the source of
// its rows; float32 and every other shape run the kernel below.  Nothing
// falls from one to the other on a failure.  hm_warp_window_attention_simt
// always runs the kernel below (for timing the two side by side).
//
// The tensor-core form.  What bounds it on the H100: by the count of
// bytes it is bound as the stripe kernel is — it reads the typed maps (a
// receiver's J sender maps once, 34 MB) instead of the warped tensor —
// but the limit it meets first is its staging: a unit's 2 x 64 rows of
// 128 bytes are not copied by cp.async but computed, 4 reads of 16 bytes
// a vector from L1 / L2 (neighbouring keys share taps), 32 widenings, two
// blends and two roundings, as much arithmetic as the pair-warp kernel
// does for the same rows.  Measured alone, the staging takes most of the
// kernel's time, arithmetic and reads about evenly, and it shares the
// instruction slots with the softmax; asking for the next unit's lines ahead
// (prefetch to L1 or L2) and 8 threads a key changed nothing.  The
// design: the stripe kernel's block and unit — (receiver, 2 heads, run of
// windows), (sender, 2 heads) — with 4 threads a key: each works the
// key's tap plan out in registers (no table in shared memory, so nothing
// grows with J) and computes every fourth of the key's 16 vectors with
// the pair warp's own routine, all reads of a vector started before its
// arithmetic, and stores the 16 bytes the pair warp would have written to
// device memory into the shared-memory row the stripe kernel fills by
// copy.  All 8 warps stage unit u + 1, then attend to unit u; the SM's
// second block computes meanwhile.  From there on it is the stripe
// kernel's code on the stripe kernel's bits.
//
// The fp32 form.  What bounds it: the attention arithmetic on the fp32
// CUDA cores, as in the stripe kernel's fp32 form; the warp adds tap
// reads that L1/L2 serve (each source vector is read by up to 4
// neighbouring keys).  One block per (receiver, window).
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
#include "window_attention_mma.cuh"
#include "window_attention_mma_kernel.cuh"

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
    const float* cf = coef + ((long long)n * nj + jj) * 8;
    const int x = pix % size, y = pix / size;
    taps[i] = hm::plan_taps<T>(cf, x, y, size);
    // the ROI tile skip: zeros, no reads, where the key's 32 x 32 tile is
    // out of the sender's view
    if (!hm::pixel_tile_in_view(cf, x, y, size)) taps[i].flag = 2;
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

// The tensor-core form: bfloat16 operands of a shape the body rule takes.
int launch_mma(const void* q, const void* src, const void* coef,
               const void* rtype, const void* bias, const void* mask,
               void* out, int n, int nj, int ty_count, int n_recv, int size,
               int win, int heads, int d, cudaStream_t stream) {
  using hm::mma::bf16;
  if (win <= 0 || size % win != 0 || heads <= 0 || n_recv <= 0 ||
      n % n_recv != 0 || ty_count <= 0 ||
      !hm::shape_takes_mma(nj, win * win, d)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || size == 0) return 0;
  hm::mma::Operands a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(src);
  a.kv_stride = 2LL * heads * d;
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.n = n, a.nj = nj, a.t = win * win, a.heads = heads;
  a.wcols = size / win;
  a.nwin = a.wcols * a.wcols;
  a.coef = static_cast<const float*>(coef);
  a.rtype = static_cast<const int*>(rtype);
  a.ty_count = ty_count, a.n_recv = n_recv;
  return hm::mma::launch_any<false, hm::mma::kWarp>(d, a, stream);
}

constexpr int kFusedKernel = 3;  // its row in the count of launches by body

}  // namespace

// q/out (N, S, S, C) with C = heads * d; src (B, TY, J, S, S, 2C) =
// typed [K | V]; coef (N, J, 8) f32 and rtype (N,) i32 as the pair warp
// takes them; bias (heads, T, T) f32; mask (N, J, S, S) f32;
// N = B * n_recv.  dtype 0 = f32, 1 = bf16.  Always the fp32 body.
extern "C" int hm_warp_window_attention_simt(
    const void* q, const void* src, const void* coef, const void* rtype,
    const void* bias, const void* mask, void* out, int dtype, int n, int nj,
    int ty_count, int n_recv, int size, int win, int heads, int d,
    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int rc = (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    rc = launch<float>(q, src, coef, rtype, bias, mask, out, n, nj, ty_count,
                       n_recv, size, win, heads, d, s);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(q, src, coef, rtype, bias, mask, out, n, nj,
                               ty_count, n_recv, size, win, heads, d, s);
  }
  return hm::counted(kFusedKernel, 0, rc);
}

// The same operands; the body by type and shape.
extern "C" int hm_warp_window_attention(const void* q, const void* src,
                                        const void* coef, const void* rtype,
                                        const void* bias, const void* mask,
                                        void* out, int dtype, int n, int nj,
                                        int ty_count, int n_recv, int size,
                                        int win, int heads, int d,
                                        void* stream) {
  if (win > 0 && hm_attention_body_rule(dtype, nj, win * win, d) == 1 &&
      hm::aligned16(q, src, bias, mask, out)) {
    return hm::counted(kFusedKernel, 1,
                       launch_mma(q, src, coef, rtype, bias, mask, out, n, nj,
                                  ty_count, n_recv, size, win, heads, d,
                                  reinterpret_cast<cudaStream_t>(stream)));
  }
  return hm_warp_window_attention_simt(q, src, coef, rtype, bias, mask, out,
                                       dtype, n, nj, ty_count, n_recv, size,
                                       win, heads, d, stream);
}
