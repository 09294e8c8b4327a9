// Plain and typed multi-sender window attention in bf16 on the tensor
// cores, over the warp-level body of attention_mma.cuh.
//
// TYPED = false replaces the Pallas kernel _plain_kernel
// (plain_window_attention) of hmvit_tpu/ops/window_attention.py: windows
// already split, q (N, Wn, T, C), [K | V] rows (N, J, Wn, T, 2C).
// TYPED = true replaces _kernel (hetero_window_attention): per pair
// (n, j) and head, sim = (q_h W_att[n, j, h]) k_j^T + bias and
// out = sum_j attn_j (v_j W_msg[n, j, h]^T), K and V separate tensors.
// Both: where(mask > 0, sim, -1e9), softmax over the J*T keys, a row
// whose max is <= -5e8 outputs 0, fp32 accumulation, bf16 out.
//
// What bounds it on the H100: bytes.  At the serving shapes (T = 64,
// d = 32, J = 4, 8 heads, 4 x 256 windows) a launch reads and writes
// 336 MB, 0.10 ms at 3.35 TB/s, against 17 GFLOP of products that the
// tensor cores do in 0.02-0.05 ms (mma.sync, the two-part operands
// included) — the fp32 cores needed 0.26 ms for them before any
// shared-memory traffic.  So the design moves each byte once, in whole
// 16-byte pieces, and keeps the memory system busy:
//   * one block per (map, group of G heads, run of windows), one warp
//     per (head of the group, 16 query rows); the unit of work is one
//     chunk of KC keys of one sender for the G heads (KC = 64 at T = 64:
//     a sender's whole window);
//   * G = 2 heads side by side where the head dim is 32 or less: a token
//     row's slice is then 128 contiguous bytes.  Device memory answers
//     64-byte slices 1 KB apart at little over half its rate (measured:
//     the same copies without any math took 0.20 ms at 64 bytes, 0.14 at
//     128, 0.34 at 32);
//   * two units in shared memory, filled by cp.async (16 bytes a copy,
//     straight from the (…, C) rows) while the warps compute on the
//     other, one __syncthreads() per unit; a window's queries ride with
//     its first unit into a ring of their own, the chunk's mask values
//     with every unit;
//   * a block walks up to 8 windows once there are blocks enough for the
//     card, and keeps its heads: at T = 64 a warp's 16 x 64 bias tile
//     stays in registers for the whole block (read per unit from L1 / L2
//     it was a quarter of the kernel's time), else it is read per chunk;
//   * shared memory per block does not grow with J (55 KB untyped, 75 KB
//     typed at the serving shapes), nor do registers (online softmax
//     over the units); registers are capped at 128 there: 2 blocks of 8
//     warps an SM.  More stages or 4 heads a row lowered that and lost;
//   * the typed form stages W_att[j, h] and W_msg[j, h] with the unit
//     and multiplies on the tensor cores, in registers (attention_mma.cuh
//     says how the intermediates keep fp32 accuracy);
//   * T other than 64 (up to 128) runs in units of 16 keys, one head a
//     block: right, not tuned — no model of the repo uses it.
#include "attention_mma.cuh"
#include "window_attention_mma.cuh"

namespace {

using namespace hm::mma;
typedef __nv_bfloat16 bf16;

// blocks wanted before a block takes more than one window
constexpr int kWantedBlocks = 1024;
constexpr int kMaxWindowsPerBlock = 8;
// heads side by side in a row where the head dim is 32 or less
constexpr int kGroup = 2;
// units in flight per block: one landing while one is computed on
constexpr int kStages = 2;

// G heads of D channels side by side in a shared-memory row; KC keys a
// unit
template <int D, int KC, int G, bool TYPED>
struct Layout {
  static constexpr int kRow = row_bytes(G * D);  // q, K, V rows
  static constexpr int kWRow = row_bytes(D);     // relation-matrix rows
  static constexpr int kPieces = G * D / 8;      // 16-byte pieces a row
  static constexpr int kMask = KC * sizeof(float);
  // one unit: the chunk's mask, KC rows of K, KC of V, and for TYPED
  // G x D rows each of W_att and W_msg
  static constexpr int kUnit =
      kMask + 2 * KC * kRow + (TYPED ? 2 * G * D * kWRow : 0);
  // the bias of a warp's rows stays in registers while every chunk is a
  // whole window (the serving shape)
  static constexpr bool kHoldBias = KC == 64;
  static constexpr int kMaxThreads = (KC == 64 ? 64 : kMaxT) / 16 * 32 * G;
  // the serving shapes keep 16 warps an SM: registers capped at 128
  static constexpr int kMinBlocks =
      KC == 64 && D <= 32 ? 512 / kMaxThreads : 1;
  static size_t bytes(int t) {
    return (size_t)kStages * ((size_t)t * kRow + kUnit);
  }
};

// grid (ceil(Wn / windows_per_block), N, heads / G), G * T / 16 warps:
// warp = (head of the group, 16 query rows)
template <int D, int KC, int G, bool TYPED>
__global__ void __launch_bounds__(Layout<D, KC, G, TYPED>::kMaxThreads,
                                   Layout<D, KC, G, TYPED>::kMinBlocks)
window_attention_mma_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, long long kv_stride,
                            const bf16* __restrict__ w_att,
                            const bf16* __restrict__ w_msg,
                            const float* __restrict__ bias,
                            const float* __restrict__ mask,
                            bf16* __restrict__ out, int nj, int nwin, int t,
                            int heads, int windows_per_block) {
  extern __shared__ uint4 smem16[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem16);
  typedef Layout<D, KC, G, TYPED> L;
  constexpr int kRow = L::kRow, kWRow = L::kWRow, kUnit = L::kUnit;
  constexpr int kPieces = L::kPieces;
  const int w0 = blockIdx.x * windows_per_block, n = blockIdx.y;
  const int h0 = blockIdx.z * G;
  const int c = heads * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = t / 16;
  const int hl = warp / tiles, tile = warp - hl * tiles;
  const int hh = h0 + hl;
  const int nkc = t / KC;            // units per sender
  const int per_window = nj * nkc;   // units per window
  const int total = min(windows_per_block, nwin - w0) * per_window;
  const long long s_per_n = (long long)nwin * t;
  unsigned char* q_ring = smem;      // kStages x t rows
  unsigned char* ring = q_ring + (size_t)kStages * t * kRow;

  // start the copies of unit u (if there is one) and close its group
  auto start_copies = [&](int u) {
    if (u < total) {
      const int wl = u / per_window, rem = u - wl * per_window;
      const int jj = rem / nkc, kc = rem - jj * nkc;
      unsigned char* stage = ring + (size_t)(u % kStages) * kUnit;
      const long long tok0 = (long long)(w0 + wl) * t;
      const long long row0 =
          ((long long)n * nj + jj) * s_per_n + tok0 + (long long)kc * KC;
      for (int i = tid; i < KC / 4; i += blockDim.x) {
        cp_async16(stage + i * 16, mask + row0 + i * 4);
      }
      const bf16* ksrc = k + row0 * kv_stride + h0 * D;
      const bf16* vsrc = v + row0 * kv_stride + h0 * D;
      unsigned char* rows = stage + L::kMask;
      for (int i = tid; i < 2 * KC * kPieces; i += blockDim.x) {
        const int r = i / kPieces, ch = i - r * kPieces;
        const bf16* src = r < KC ? ksrc + (long long)r * kv_stride
                                 : vsrc + (long long)(r - KC) * kv_stride;
        cp_async16(rows + r * kRow + ch * 16, src + ch * 8);
      }
      if constexpr (TYPED) {
        // W_att[n, jj, h0 .. h0 + G), then W_msg of the same heads
        const long long at =
            (((long long)n * nj + jj) * heads + h0) * (long long)(D * D);
        unsigned char* ws = rows + 2 * KC * kRow;
        for (int i = tid; i < 2 * G * D * (D / 8); i += blockDim.x) {
          const int r = i / (D / 8), ch = i - r * (D / 8);
          const bf16* src = r < G * D ? w_att + at + r * D
                                      : w_msg + at + (r - G * D) * D;
          cp_async16(ws + r * kWRow + ch * 16, src + ch * 8);
        }
      }
      if (rem == 0) {  // the window's queries ride with its first unit
        unsigned char* qs = q_ring + (size_t)(wl % kStages) * t * kRow;
        const bf16* qsrc = q + ((long long)n * s_per_n + tok0) * c + h0 * D;
        for (int i = tid; i < t * kPieces; i += blockDim.x) {
          const int r = i / kPieces, ch = i - r * kPieces;
          cp_async16(qs + r * kRow + ch * 16,
                     qsrc + (long long)r * c + ch * 8);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) start_copies(u);

  const float* bias_rows = bias + ((long long)hh * t + tile * 16) * t;
  BiasTile<KC> bt;
  if constexpr (L::kHoldBias) load_bias<KC>(bt, bias_rows, t, lane);

  RowTile<D> rt;
  int wl = 0, rem = 0;
  for (int u = 0; u < total; ++u) {
    // unit u has landed for this thread; after the barrier for all, and
    // every warp is done with unit u - 1, whose slot (and, kStages
    // windows on, whose query slot) the next copies overwrite
    cp_async_wait<kStages - 2>();
    __syncthreads();
    start_copies(u + kStages - 1);

    const int jj = rem / nkc, kc = rem - jj * nkc;
    unsigned char* q_rows = q_ring +
                            ((size_t)(wl % kStages) * t + tile * 16) * kRow +
                            hl * D * 2;
    if (rem == 0) begin_head<D, kRow>(rt, q_rows, lane);
    const unsigned char* stage = ring + (size_t)(u % kStages) * kUnit;
    const unsigned char* rows = stage + L::kMask + hl * D * 2;
    const unsigned char* ws = stage + L::kMask + 2 * KC * kRow;
    if constexpr (!L::kHoldBias) {
      load_bias<KC>(bt, bias_rows + kc * KC, t, lane);
    }
    attend_chunk<D, KC, TYPED, kRow>(
        rt, rows, rows + KC * kRow, ws + hl * D * kWRow,
        ws + (G + hl) * D * kWRow, bt,
        reinterpret_cast<const float*>(stage), lane);
    if (++rem == per_window) {
      end_head<D, kRow>(rt, q_rows,
                        out + ((long long)n * s_per_n +
                               (long long)(w0 + wl) * t + tile * 16) * c +
                            hh * D,
                        c, lane);
      rem = 0;
      ++wl;
    }
  }
  cp_async_wait<0>();
}

template <int D, int KC, int G, bool TYPED>
int launch(const void* q, const void* k, const void* v, long long kv_stride,
           const void* w_att, const void* w_msg, const void* bias,
           const void* mask, void* out, int n, int nj, int nwin, int t,
           int heads, cudaStream_t stream) {
  const size_t bytes = Layout<D, KC, G, TYPED>::bytes(t);
  auto kernel = window_attention_mma_kernel<D, KC, G, TYPED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // a block keeps its heads (their bias tiles in registers) and walks
  // several windows once there are blocks enough to fill the card
  const long long items = (long long)n * nwin * (heads / G);
  const int per_block = (int)max(
      1LL, min((long long)kMaxWindowsPerBlock, items / kWantedBlocks));
  dim3 grid((nwin + per_block - 1) / per_block, n, heads / G);
  kernel<<<grid, G * (t / 16) * 32, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), kv_stride,
      static_cast<const bf16*>(w_att), static_cast<const bf16*>(w_msg),
      static_cast<const float*>(bias), static_cast<const float*>(mask),
      static_cast<bf16*>(out), nj, nwin, t, heads, per_block);
  return (int)cudaGetLastError();
}

template <int D, bool TYPED, typename... Args>
int launch_d(int t, int heads, Args... args) {
  // T = 64 (window 8): a sender's window in one unit and, for head dims
  // up to 32, kGroup heads side by side (128-byte rows at head dim 32);
  // any other T in units of 16 keys, one head a block
  if (t == 64) {
    if constexpr (D <= 32) {
      if (heads % kGroup == 0) {
        return launch<D, 64, kGroup, TYPED>(args...);
      }
    }
    return launch<D, 64, 1, TYPED>(args...);
  }
  return launch<D, 16, 1, TYPED>(args...);
}

template <bool TYPED, typename... Args>
int launch_any(int d, int t, int heads, Args... args) {
  switch (d) {
    case 16: return launch_d<16, TYPED>(t, heads, args...);
    case 32: return launch_d<32, TYPED>(t, heads, args...);
    case 48: return launch_d<48, TYPED>(t, heads, args...);
    case 64: return launch_d<64, TYPED>(t, heads, args...);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

namespace hm {

bool shape_takes_mma(int nj, int t, int d) {
  return nj > 0 && t > 0 && t % 16 == 0 && t <= mma::kMaxT && d > 0 &&
         d % 16 == 0 && d <= 64 && nj * t <= mma::kMaxKeys;
}

int launch_window_attention_mma(const void* q, const void* k, const void* v,
                                long long kv_stride, const void* w_att,
                                const void* w_msg, const void* bias,
                                const void* mask, void* out, int n, int nj,
                                int nwin, int t, int heads, int d,
                                cudaStream_t stream) {
  if (!shape_takes_mma(nj, t, d) || heads <= 0 ||
      (w_att == nullptr) != (w_msg == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || nwin == 0) return 0;
  if (w_att != nullptr) {
    return launch_any<true>(d, t, heads, q, k, v, kv_stride, w_att, w_msg,
                            bias, mask, out, n, nj, nwin, t, heads, stream);
  }
  return launch_any<false>(d, t, heads, q, k, v, kv_stride, w_att, w_msg,
                           bias, mask, out, n, nj, nwin, t, heads, stream);
}

}  // namespace hm
