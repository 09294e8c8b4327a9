// Plain, stripe and typed multi-sender window attention in bf16 on the
// tensor cores: the kernel of window_attention_mma_kernel.cuh over the
// warp-level body of attention_mma.cuh.
//
// TYPED = false replaces two Pallas kernels of
// hmvit_tpu/ops/window_attention.py: _plain_kernel
// (plain_window_attention; kSplit: windows already split, q (N, Wn, T,
// C), [K | V] rows (N, J, Wn, T, 2C)) and _stripe_kernel
// (stripe_window_attention; kStripe: local windows read straight from
// (N, H, W, C) / (N, J, H, W, 2C) maps — the same kernel with another
// address map: a window row is win neighbouring pixels, so a token's
// slice stays 128 contiguous bytes and four mask values one copy).
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
#include "window_attention_mma.cuh"
#include "window_attention_mma_kernel.cuh"

namespace hm {

bool shape_takes_mma(int nj, int t, int d) {
  return nj > 0 && t > 0 && t % 16 == 0 && t <= mma::kMaxT && d > 0 &&
         d % 16 == 0 && d <= 64 && nj * t <= mma::kMaxKeys;
}

int launch_window_attention_mma(const void* q, const void* k, const void* v,
                                long long kv_stride, const void* w_att,
                                const void* w_msg, const void* bias,
                                const void* mask, void* out, int n, int nj,
                                int nwin, int t, int wcols, int heads, int d,
                                cudaStream_t stream) {
  using mma::bf16;
  if (!shape_takes_mma(nj, t, d) || heads <= 0 || wcols < 0 ||
      (w_att == nullptr) != (w_msg == nullptr) ||
      (wcols > 0 && (w_att != nullptr || nwin % wcols != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || nwin == 0) return 0;
  mma::Operands a = {};
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.kv_stride = kv_stride;
  a.w_att = static_cast<const bf16*>(w_att);
  a.w_msg = static_cast<const bf16*>(w_msg);
  a.bias = static_cast<const float*>(bias);
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<bf16*>(out);
  a.n = n, a.nj = nj, a.nwin = nwin, a.t = t, a.heads = heads;
  a.wcols = wcols;
  if (wcols > 0) return mma::launch_any<false, mma::kStripe>(d, a, stream);
  if (w_att != nullptr) return mma::launch_any<true, mma::kSplit>(d, a, stream);
  return mma::launch_any<false, mma::kSplit>(d, a, stream);
}

}  // namespace hm
