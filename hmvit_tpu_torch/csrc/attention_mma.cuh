// Multi-sender window attention on the tensor cores: what one warp does
// with 16 query rows of one window and head, on bf16 operands that a
// block has staged in shared memory.  Beside attention_body.cuh (fp32
// CUDA cores, any storage type), which every float32 launch and the
// bfloat16 shapes outside this body's rule keep.
//
// sim = q . k over all J*T keys (q arrives scaled),
// where(mask > 0, sim + bias[t, s mod T], -1e9), softmax over the J*T
// keys, a row whose max is <= -5e8 outputs 0, out = attn . v; the typed
// form scores (q W_att[j]) . k_j and sums attn_j . (v_j W_msg[j]^T).
//
// The keys arrive in chunks of KC (one sender's window, or a part of
// it); a warp keeps a running max and sum per row (online softmax, fp32,
// in the base-2 domain: one fma folds the bias and log2(e) into the
// score, P is one subtraction and one ex2) and its 16 x D output in
// registers, so nothing but the chunk in flight has to be resident and
// registers do not grow with J.  Products are mma.sync.m16n8k16
// (bf16 x bf16 -> f32) on fragments read with ldmatrix: K and W_msg are
// the "col" B operand as they lie (row = the output column), V and W_att
// go through ldmatrix.trans.
//
// Where an fp32 intermediate has to become an mma operand it is rounded
// to bf16 once where that keeps the output within a bf16 ulp of the fp32
// result, and else carried as two bf16 parts, hi = bf16(x) and
// lo = bf16(x - hi), and multiplied twice.  One part: the untyped form's
// probabilities P (as every flash-attention kernel does; the row sum
// stays fp32).  Two parts: the typed queries q W_att (one rounding moves
// a logit by ~0.01 at unit-normal inputs and the output by up to 0.06),
// the typed form's P and its per-sender P . V, which then meets W_msg^T:
// (P V) W^T instead of P (V W^T), the same sum in another order, so that
// no transformed value goes back to shared memory.
//
// Shared-memory rows are their payload plus 16 bytes of padding: the row
// stride is an odd multiple of 16 bytes, so the 8 rows of one ldmatrix
// 8 x 8 tile fall into 8 different 16-byte bank groups.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace hm {
namespace mma {

constexpr int kMaxT = 128;   // one warp per 16 query rows: 8 warps
constexpr int kMaxKeys = 320;

// bytes of a shared-memory row of `width` bf16
__host__ __device__ constexpr int row_bytes(int width) {
  return 2 * width + 16;
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, past L1; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 tiles; lanes 8i..8i+7 give the row addresses of tile i,
// register i of lane l holds row l / 4, columns 2 (l % 4) and + 1 of
// tile i (.trans: of its transpose)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, row) . b (16 x 8, col).  With g = lane /
// 4, i = lane % 4: a = {(g, 2i..), (g + 8, 2i..), (g, 2i + 8..), (g + 8,
// 2i + 8..)}, b = {(k 2i.., n g), (k 2i + 8.., n g)}, c = {(g, 2i), (g,
// 2i + 1), (g + 8, 2i), (g + 8, 2i + 1)}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// 2^x, x = -inf gives 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (x, y) as packed bf16 pairs: hi = bf16(.) and, with LO, lo = bf16(. - hi)
template <bool LO>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = as_u32(h);
  if constexpr (LO) {
    lo = as_u32(__floats2bfloat162_rn(x - __low2float(h),
                                      y - __high2float(h)));
  }
}

// an accumulator of N / 8 tiles (16 x N, f32) as the A operand of N / 16
// k-steps, in two bf16 parts
template <int N>
__device__ __forceinline__ void split_accumulator(
    const float (&c)[N / 8][4], uint32_t (&hi)[N / 16][4],
    uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < N / 16; ++ks) {
    split_pair<true>(c[2 * ks][0], c[2 * ks][1], hi[ks][0], lo[ks][0]);
    split_pair<true>(c[2 * ks][2], c[2 * ks][3], hi[ks][1], lo[ks][1]);
    split_pair<true>(c[2 * ks + 1][0], c[2 * ks + 1][1], hi[ks][2],
                     lo[ks][2]);
    split_pair<true>(c[2 * ks + 1][2], c[2 * ks + 1][3], hi[ks][3],
                     lo[ks][3]);
  }
}

// this lane's byte offset inside a 16-row x 16-column ldmatrix.x4 block
// of rows RB bytes apart, whose tiles are ordered (rows 0-7, cols 0-7),
// (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15):
// the A operand, and with .trans the B operand of a row-major [k][n]
// matrix (V, W_att)
template <int RB>
__device__ __forceinline__ uint32_t lane_offset_16x16(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * RB + (lane >> 4) * 16;
}

// B fragments of rows [8 nt, 8 nt + 8) of a row-major [n][k] matrix (K,
// W_msg; rows RB bytes apart) for every k-step of D: 8-row x 32-column
// ldmatrix.x4 blocks, four tiles side by side, two k-steps each
template <int D, int RB>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[D / 16][2],
                                            uint32_t base, int nt, int lane) {
  const uint32_t tile = base + (nt * 8 + (lane & 7)) * RB;
#pragma unroll
  for (int p = 0; p < D / 32; ++p) {
    uint32_t r[4];
    ldmatrix_x4(r, tile + p * 64 + (lane >> 3) * 16);
    b[2 * p][0] = r[0];
    b[2 * p][1] = r[1];
    b[2 * p + 1][0] = r[2];
    b[2 * p + 1][1] = r[3];
  }
  if constexpr ((D / 16) % 2 == 1) {  // a last k-step on its own
    constexpr int ks = D / 16 - 1;
    ldmatrix_x2(b[ks], tile + ks * 32 + ((lane >> 3) & 1) * 16);
  }
}

// c (16 x D) += a (16 x K, in K / 16 k-steps, one or two bf16 parts) .
// m (K x D, row-major in shared memory at base, rows RB bytes apart),
// through ldmatrix.trans
template <int D, int K, bool TWO_PARTS, int RB>
__device__ __forceinline__ void mma_rowmajor_b(
    float (&c)[D / 8][4], const uint32_t (&a_hi)[K / 16][4],
    const uint32_t (&a_lo)[K / 16][4], uint32_t base, int lane) {
  const uint32_t at = base + lane_offset_16x16<RB>(lane);
#pragma unroll
  for (int ks = 0; ks < K / 16; ++ks) {
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, at + ks * 16 * RB + np * 32);
      mma_bf16(c[2 * np], a_hi[ks], b[0], b[1]);
      mma_bf16(c[2 * np + 1], a_hi[ks], b[2], b[3]);
      if constexpr (TWO_PARTS) {
        mma_bf16(c[2 * np], a_lo[ks], b[0], b[1]);
        mma_bf16(c[2 * np + 1], a_lo[ks], b[2], b[3]);
      }
    }
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// What a warp carries through the key chunks of one window and head: its
// 16 query rows as A fragments and, for rows g = lane / 4 ([0]) and
// g + 8 ([1]), the running max, this lane's part of the running sum, and
// the output.
template <int D>
struct RowTile {
  uint32_t q[D / 16][4];
  float o[D / 8][4];
  float m[2];
  float l[2];
};

// Scores live in the base-2 domain: (q . k + bias) log2(e), a masked key
// -1e9 log2(e), so that P = 2^(s - max) is one subtraction and one ex2.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMasked = -1e9f * kLog2e;
constexpr float kDeadRow = -5e8f * kLog2e;  // a row whose max is <= this

// a 16 x KC tile of bias . log2(e) in the accumulator's own layout
template <int KC>
struct BiasTile {
  float2 lo[KC / 8];  // row g, columns 8 nt + 2 i, + 1
  float2 hi[KC / 8];  // row g + 8
};

// bias_row: bias[h] at (the warp's first row, the chunk's first token),
// rows t floats apart, in global memory
template <int KC>
__device__ __forceinline__ void load_bias(BiasTile<KC>& bt,
                                          const float* __restrict__ bias_row,
                                          int t, int lane) {
  const float* lo = bias_row + (long long)(lane >> 2) * t + (lane & 3) * 2;
  const float* hi = lo + 8LL * t;
#pragma unroll
  for (int nt = 0; nt < KC / 8; ++nt) {
    bt.lo[nt] = __ldg(reinterpret_cast<const float2*>(lo + nt * 8));
    bt.hi[nt] = __ldg(reinterpret_cast<const float2*>(hi + nt * 8));
    bt.lo[nt].x *= kLog2e;
    bt.lo[nt].y *= kLog2e;
    bt.hi[nt].x *= kLog2e;
    bt.hi[nt].y *= kLog2e;
  }
}

// start a window's head: q_rows points at the warp's first query row and
// the head's first channel in shared memory (rows RB bytes apart)
template <int D, int RB>
__device__ __forceinline__ void begin_head(RowTile<D>& rt,
                                           const unsigned char* q_rows,
                                           int lane) {
  const uint32_t at = shared_addr(q_rows) + lane_offset_16x16<RB>(lane);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) ldmatrix_x4(rt.q[ks], at + ks * 32);
#pragma unroll
  for (int ot = 0; ot < D / 8; ++ot) {
#pragma unroll
    for (int e = 0; e < 4; ++e) rt.o[ot][e] = 0.f;
  }
  rt.m[0] = rt.m[1] = -INFINITY;
  rt.l[0] = rt.l[1] = 0.f;
}

// one chunk of KC keys of one sender.  ks_, vs_: the head's channels of
// KC rows each, RB bytes apart; was_, wms_ (TYPED): W_att[j, h] as
// [d_in][d_out] and W_msg[j, h] as [d_out][d_in], D rows each,
// row_bytes(D) apart; bt: the bias of these rows and keys; mask_keys:
// the chunk's KC mask values in shared memory.
template <int D, int KC, bool TYPED, int RB>
__device__ __forceinline__ void attend_chunk(
    RowTile<D>& rt, const unsigned char* ks_, const unsigned char* vs_,
    const unsigned char* was_, const unsigned char* wms_,
    const BiasTile<KC>& bt, const float* mask_keys, int lane) {
  static_assert(KC % 16 == 0, "keys in k-steps of 16");
  constexpr int KS = D / 16;
  constexpr int NT = KC / 8;
  constexpr int OT = D / 8;
  constexpr int WB = row_bytes(D);
  // P multiplies V in one bf16 part; the typed form, whose P . V meets a
  // second product, carries two
  constexpr bool P_LO = TYPED;
  const int i2 = (lane & 3) * 2;

  // the A operand of the scores: q, or q W_att[j] in two parts
  uint32_t a_hi[KS][4], a_lo[KS][4];
  if constexpr (TYPED) {
    float qw[OT][4];
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
#pragma unroll
      for (int e = 0; e < 4; ++e) qw[ot][e] = 0.f;
    }
    mma_rowmajor_b<D, D, false, WB>(qw, rt.q, rt.q, shared_addr(was_), lane);
    split_accumulator<D>(qw, a_hi, a_lo);
  }

  float s[NT][4];
  const uint32_t k_base = shared_addr(ks_);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    uint32_t kb[KS][2];
    load_b_rows<D, RB>(kb, k_base, nt, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if constexpr (TYPED) {
        mma_bf16(s[nt], a_hi[ks], kb[ks][0], kb[ks][1]);
        mma_bf16(s[nt], a_lo[ks], kb[ks][0], kb[ks][1]);
      } else {
        mma_bf16(s[nt], rt.q[ks], kb[ks][0], kb[ks][1]);
      }
    }
  }

  // bias and mask in the accumulator's own layout, then the running max
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 live =
        *reinterpret_cast<const float2*>(mask_keys + nt * 8 + i2);
    s[nt][0] = live.x > 0.f ? fmaf(s[nt][0], kLog2e, bt.lo[nt].x) : kMasked;
    s[nt][1] = live.y > 0.f ? fmaf(s[nt][1], kLog2e, bt.lo[nt].y) : kMasked;
    s[nt][2] = live.x > 0.f ? fmaf(s[nt][2], kLog2e, bt.hi[nt].x) : kMasked;
    s[nt][3] = live.y > 0.f ? fmaf(s[nt][3], kLog2e, bt.hi[nt].y) : kMasked;
    mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
  }
  float scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // a masked key scores kMasked, so the max is finite from the first
    // chunk on and 2^(-inf - finite) = 0 empties the initial state
    const float m_new = fmaxf(rt.m[r], quad_max(mx[r]));
    scale[r] = exp2_approx(rt.m[r] - m_new);
    rt.m[r] = m_new;
  }

  // P = 2^(s - max) in bf16 parts, as the A operand of P . V; the row
  // sum adds the fp32 values
  uint32_t p_hi[KC / 16][4], p_lo[KC / 16][4];
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float x = exp2_approx(s[nt][2 * r] - rt.m[r]);
      const float y = exp2_approx(s[nt][2 * r + 1] - rt.m[r]);
      sum[r] += x + y;
      // tile nt is k-step nt / 2, registers r (+ 2 for the odd tile)
      split_pair<P_LO>(x, y, p_hi[nt / 2][(nt & 1) * 2 + r],
                       p_lo[nt / 2][(nt & 1) * 2 + r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) rt.l[r] = rt.l[r] * scale[r] + sum[r];
#pragma unroll
  for (int ot = 0; ot < OT; ++ot) {
    rt.o[ot][0] *= scale[0];
    rt.o[ot][1] *= scale[0];
    rt.o[ot][2] *= scale[1];
    rt.o[ot][3] *= scale[1];
  }

  if constexpr (TYPED) {
    // (P V_j) W_msg[j]^T: the chunk's P . V in two parts, then W_msg as
    // the "col" operand as it lies ([d_out][d_in])
    float pv[OT][4];
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[ot][e] = 0.f;
    }
    mma_rowmajor_b<D, KC, P_LO, RB>(pv, p_hi, p_lo, shared_addr(vs_), lane);
    uint32_t t_hi[KS][4], t_lo[KS][4];
    split_accumulator<D>(pv, t_hi, t_lo);
    const uint32_t w_base = shared_addr(wms_);
#pragma unroll
    for (int ot = 0; ot < OT; ++ot) {
      uint32_t wb[KS][2];
      load_b_rows<D, WB>(wb, w_base, ot, lane);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        mma_bf16(rt.o[ot], t_hi[ks], wb[ks][0], wb[ks][1]);
        mma_bf16(rt.o[ot], t_lo[ks], wb[ks][0], wb[ks][1]);
      }
    }
  } else {
    mma_rowmajor_b<D, KC, P_LO, RB>(rt.o, p_hi, p_lo, shared_addr(vs_),
                                    lane);
  }
}

// end a window's head: normalise, zero the rows that saw no live key,
// and write the warp's 16 x D block.  It goes through the warp's own
// query rows and channels in shared memory (q_rows, read by no other
// warp) so that every token row leaves as whole 16-byte pieces;
// out_head points at channel h * D of the window's first token, and
// row_at(r) gives the element offset of the warp's r-th token from there
// (tokens lie in a line when the windows are split, in rows of the map
// when they are not).
template <int D, int RB, typename RowAt>
__device__ __forceinline__ void end_head(RowTile<D>& rt,
                                         unsigned char* q_rows,
                                         __nv_bfloat16* out_head,
                                         RowAt row_at, int lane) {
  const int g = lane >> 2, i2 = (lane & 3) * 2;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(rt.l[r]);
    inv[r] = rt.m[r] <= kDeadRow ? 0.f : 1.f / l;
  }
  __syncwarp();
#pragma unroll
  for (int ot = 0; ot < D / 8; ++ot) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<uint32_t*>(q_rows + (g + 8 * r) * RB +
                                   (ot * 8 + i2) * 2) =
          as_u32(__floats2bfloat162_rn(rt.o[ot][2 * r] * inv[r],
                                       rt.o[ot][2 * r + 1] * inv[r]));
    }
  }
  __syncwarp();
  constexpr int kPieces = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kPieces; i += 32) {
    const int row = i / kPieces, ch = i - row * kPieces;
    *reinterpret_cast<uint4*>(out_head + row_at(row) + ch * 8) =
        *reinterpret_cast<const uint4*>(q_rows + row * RB + ch * 16);
  }
}

}  // namespace mma
}  // namespace hm
