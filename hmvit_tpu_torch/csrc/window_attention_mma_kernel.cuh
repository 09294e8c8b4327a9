// The block-level kernel of multi-sender window attention in bf16 on the
// tensor cores, over the warp-level body of attention_mma.cuh, and its
// launcher.  One kernel template, three sources of a unit's K / V rows:
//   * kSplit  — windows already split, q (N, Wn, T, C), [K | V] rows
//     (N, J, Wn, T, .): the plain kernel and (TYPED) the typed one;
//   * kStripe — local windows read straight from unsplit maps, q
//     (N, H, W, C), [K | V] (N, J, H, W, 2C): window (wy, wx), token
//     (ty, tx) is pixel (wy*win + ty, wx*win + tx), so a window is win
//     runs of win neighbouring pixels; win = 8 (T = 64) or 4 (T = 16);
//   * kWarp   — the stripe layout, but a unit's rows are not copied: each
//     16-byte vector is computed from the typed sender maps
//     src[b, rtype[n], j] by the pair warp's own tap routine
//     (warp_taps.cuh) and stored to the shared-memory row the stripe
//     source would have filled by copy — the bits the pair warp would
//     have written to device memory.  Everything after the staging is
//     the same code on the same bits: fused == pair warp -> stripe is a
//     property of the build.
// window_attention_mma.cu instantiates the first two, and says what
// bounds the kernel (bytes) and how it is laid out;
// fused_warp_attention.cu instantiates the third.
#pragma once
#include "attention_mma.cuh"
#include "warp_taps.cuh"

namespace hm {
namespace mma {

typedef __nv_bfloat16 bf16;

enum Source { kSplit = 0, kStripe = 1, kWarp = 2 };

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

// What a launch reads and writes.  k, v: token rows kv_stride elements
// apart (2C and v = k + C for [K | V] rows, C for separate tensors).
// kStripe and kWarp: wcols windows in a row of the map.  kWarp: k is
// the typed sender maps (B, TY, J, S, S, 2C), v is unused, coef (N, J,
// 8) f32 and rtype (N,) i32 as the pair warp takes them, N = B * n_recv.
struct Operands {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  long long kv_stride;
  const bf16* w_att;
  const bf16* w_msg;
  const float* bias;
  const float* mask;
  bf16* out;
  int n, nj, nwin, t, heads;
  int wcols;
  const float* coef;
  const int* rtype;
  int ty_count, n_recv;
};

// grid (ceil(Wn / windows_per_block), N, heads / G), G * T / 16 warps:
// warp = (head of the group, 16 query rows)
template <int D, int KC, int G, bool TYPED, int MODE>
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
                            int heads, int windows_per_block, int wcols,
                            const float* __restrict__ coef,
                            const int* __restrict__ rtype, int ty_count,
                            int n_recv) {
  static_assert(MODE == kSplit || !TYPED, "typed windows arrive split");
  extern __shared__ uint4 smem16[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem16);
  typedef Layout<D, KC, G, TYPED> L;
  constexpr int kRow = L::kRow, kWRow = L::kWRow, kUnit = L::kUnit;
  constexpr int kPieces = L::kPieces;
  // the unsplit layouts: T = 64 is window 8 (one unit a sender), T = 16
  // window 4
  constexpr int kWin = KC == 64 ? 8 : 4;
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
  const int map_w = wcols * kWin;    // pixels in a row of an unsplit map
  unsigned char* q_ring = smem;      // kStages x t rows
  unsigned char* ring = q_ring + (size_t)kStages * t * kRow;

  // the first token of window w within its map, and how far token tt of
  // a window lies behind it
  auto window_origin = [&](int w) -> long long {
    if constexpr (MODE == kSplit) {
      return (long long)w * t;
    } else {
      const int wy = w / wcols, wx = w - wy * wcols;
      return ((long long)wy * map_w + wx) * kWin;
    }
  };
  auto token_offset = [&](int tt) -> int {
    if constexpr (MODE == kSplit) {
      return tt;
    } else {
      return (tt / kWin) * map_w + tt % kWin;
    }
  };

  // kWarp: whether the 32 x 32 tile of each (window of the block,
  // sender) is in the sender's view, worked out once a block (a window
  // lies in one tile: its edge divides 32)
  __shared__ bool in_view[kMaxWindowsPerBlock * (kMaxKeys / 16)];
  if constexpr (MODE == kWarp) {
    const int nw = min(windows_per_block, nwin - w0);
    for (int i = tid; i < nw * nj; i += blockDim.x) {
      const int wl = i / nj, jj = i - wl * nj;
      const int wy = (w0 + wl) / wcols, wx = (w0 + wl) - wy * wcols;
      in_view[i] = pixel_tile_in_view(coef + ((long long)n * nj + jj) * 8,
                                      wx * kWin, wy * kWin, map_w);
    }
    __syncthreads();
  }

  // bring unit u (if there is one) into its stage and close its group of
  // copies
  auto stage_unit = [&](int u) {
    if (u < total) {
      const int wl = u / per_window, rem = u - wl * per_window;
      const int jj = rem / nkc, kc = rem - jj * nkc;
      unsigned char* stage = ring + (size_t)(u % kStages) * kUnit;
      const long long tok0 = window_origin(w0 + wl);
      const long long map0 = ((long long)n * nj + jj) * s_per_n;
      // four mask values a copy: neighbours in either layout
      for (int i = tid; i < KC / 4; i += blockDim.x) {
        cp_async16(stage + i * 16,
                   mask + map0 + tok0 + token_offset(kc * KC + i * 4));
      }
      unsigned char* rows = stage + L::kMask;
      if constexpr (MODE == kWarp) {
        // sender jj's typed map in this receiver's variant, at the
        // block's first channel
        const bf16* src =
            k +
            ((((long long)(n / n_recv) * ty_count + rtype[n]) * nj + jj) *
             s_per_n) * kv_stride +
            h0 * D;
        const float* cf = coef + ((long long)n * nj + jj) * 8;
        // blockDim / KC threads a key, each with the key's tap plan in
        // registers and every blockDim / KC-th of the key's 16-byte
        // vectors: the K pieces of the G heads, then the V pieces
        const int per_key = blockDim.x / KC;
        const int key = tid / per_key, part = tid - key * per_key;
        const int pix = (int)tok0 + token_offset(kc * KC + key);
        const int y = pix / map_w;
        WarpTaps plan = plan_taps<bf16>(cf, pix - y * map_w, y, map_w);
        // the ROI tile skip: a window whose 32 x 32 tile is out of view
        // for this sender stages the zeros the taps would give, reading
        // nothing
        if (!in_view[wl * nj + jj]) plan.flag = 2;
        for (int vec = part; vec < 2 * kPieces; vec += per_key) {
          const bool is_v = vec >= kPieces;
          const int ch = is_v ? vec - kPieces : vec;
          *reinterpret_cast<uint4*>(rows + ((is_v ? KC : 0) + key) * kRow +
                                    ch * 16) =
              warp_vec16<bf16>(plan, src + (is_v ? c : 0) + ch * 8,
                               (int)kv_stride, pix);
        }
      } else {
        const bf16* ksrc = k + (map0 + tok0) * kv_stride + h0 * D;
        const bf16* vsrc = v + (map0 + tok0) * kv_stride + h0 * D;
        for (int i = tid; i < 2 * KC * kPieces; i += blockDim.x) {
          const int r = i / kPieces, ch = i - r * kPieces;
          const int key = r < KC ? r : r - KC;
          const bf16* src = (r < KC ? ksrc : vsrc) +
                            token_offset(kc * KC + key) * kv_stride;
          cp_async16(rows + r * kRow + ch * 16, src + ch * 8);
        }
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
                     qsrc + (long long)token_offset(r) * c + ch * 8);
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) stage_unit(u);

  const float* bias_rows = bias + ((long long)hh * t + tile * 16) * t;
  BiasTile<KC> bt;
  if constexpr (L::kHoldBias) load_bias<KC>(bt, bias_rows, t, lane);

  RowTile<D> rt;
  int wl = 0, rem = 0;
  for (int u = 0; u < total; ++u) {
    // unit u has landed for this thread; after the barrier for all (the
    // rows a kWarp block computed included), and every warp is done with
    // unit u - 1, whose slot (and, kStages windows on, whose query slot)
    // the next unit overwrites
    cp_async_wait<kStages - 2>();
    __syncthreads();
    stage_unit(u + kStages - 1);

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
      end_head<D, kRow>(
          rt, q_rows,
          out + ((long long)n * s_per_n + window_origin(w0 + wl)) * c +
              hh * D,
          [&](int row) {
            return (long long)token_offset(tile * 16 + row) * c;
          },
          lane);
      rem = 0;
      ++wl;
    }
  }
  cp_async_wait<0>();
}

template <int D, int KC, int G, bool TYPED, int MODE>
int launch(const Operands& a, cudaStream_t stream) {
  const size_t bytes = Layout<D, KC, G, TYPED>::bytes(a.t);
  auto kernel = window_attention_mma_kernel<D, KC, G, TYPED, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // a block keeps its heads (their bias tiles in registers) and walks
  // several windows once there are blocks enough to fill the card
  const long long items = (long long)a.n * a.nwin * (a.heads / G);
  const int per_block = (int)max(
      1LL, min((long long)kMaxWindowsPerBlock, items / kWantedBlocks));
  dim3 grid((a.nwin + per_block - 1) / per_block, a.n, a.heads / G);
  kernel<<<grid, G * (a.t / 16) * 32, bytes, stream>>>(
      a.q, a.k, a.v, a.kv_stride, a.w_att, a.w_msg, a.bias, a.mask, a.out,
      a.nj, a.nwin, a.t, a.heads, per_block, a.wcols, a.coef, a.rtype,
      a.ty_count, a.n_recv);
  return (int)cudaGetLastError();
}

template <int D, bool TYPED, int MODE>
int launch_d(const Operands& a, cudaStream_t stream) {
  // T = 64 (window 8): a sender's window in one unit and, for head dims
  // up to 32, kGroup heads side by side (128-byte rows at head dim 32);
  // any other T in units of 16 keys, one head a block
  if (a.t == 64) {
    if constexpr (D <= 32) {
      if (a.heads % kGroup == 0) {
        return launch<D, 64, kGroup, TYPED, MODE>(a, stream);
      }
    }
    return launch<D, 64, 1, TYPED, MODE>(a, stream);
  }
  // an unsplit layout has no other window than 8 x 8 or 4 x 4
  if (MODE != kSplit && a.t != 16) return (int)cudaErrorInvalidValue;
  return launch<D, 16, 1, TYPED, MODE>(a, stream);
}

// d: the head dim, one of the body rule's (16, 32, 48, 64)
template <bool TYPED, int MODE>
int launch_any(int d, const Operands& a, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_d<16, TYPED, MODE>(a, stream);
    case 32: return launch_d<32, TYPED, MODE>(a, stream);
    case 48: return launch_d<48, TYPED, MODE>(a, stream);
    case 64: return launch_d<64, TYPED, MODE>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma
}  // namespace hm
