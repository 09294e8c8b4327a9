// Host interface of window_attention_mma.cu: the tensor-core kernels of
// plain, stripe and typed window attention, launched by the C entry
// points in window_attention.cu when shape_takes_mma() says so; and the
// count of attention launches by kernel and body, kept there.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

// The rule of every attention entry point (defined in
// window_attention.cu): 1 when bfloat16 (dtype 1) operands of this shape
// go to the tensor-core body, 0 when to the fp32 body, -1 when no kernel
// takes them.
extern "C" int hm_attention_body_rule(int dtype, int nj, int t, int d);

namespace hm {

// The bf16 shapes the tensor-core body takes: T a multiple of 16 up to
// 128 (one warp per 16 query rows), d a multiple of 16 up to 64, at
// most 320 keys.  Everything else, and float32, stays on the fp32 body.
bool shape_takes_mma(int nj, int t, int d);

// q/out (N, Wn, T, C) bf16; k, v: (N, J, Wn, T, .) bf16 with token rows
// kv_stride elements apart (2C and v = k + C for [K | V] rows, C for
// separate tensors); w_att, w_msg (N, J, heads, d, d) bf16 or both null
// (untyped); bias (heads, T, T) f32; mask (N, J, Wn, T) f32.  wcols = 0:
// windows already split; wcols > 0 (untyped only): the maps are unsplit,
// q/out (N, H, W, C), k, v (N, J, H, W, .), mask (N, J, H, W), with
// wcols windows of sqrt(T) x sqrt(T) pixels in a row of the map.  Every
// pointer 16-byte aligned (the copies are 16-byte cp.async).  Returns a
// cudaError_t.
int launch_window_attention_mma(const void* q, const void* k, const void* v,
                                long long kv_stride, const void* w_att,
                                const void* w_msg, const void* bias,
                                const void* mask, void* out, int n, int nj,
                                int nwin, int t, int wcols, int heads, int d,
                                cudaStream_t stream);

// every pointer on a 16-byte boundary (what the tensor-core kernels'
// copies need)
template <typename... P>
bool aligned16(P... ptrs) {
  return ((reinterpret_cast<uintptr_t>(ptrs) | ...) & 15) == 0;
}

// Attention launches by kernel (0 stripe, 1 plain, 2 typed, 3 fused warp
// + attention) and body (0 fp32 CUDA cores, 1 tensor cores): adds one
// where rc is 0, returns rc.
int counted(int kernel, int body, int rc);

}  // namespace hm
