// Host interface of window_attention_mma.cu: the tensor-core kernels of
// plain and typed window attention, launched by the C entry points in
// window_attention.cu when shape_takes_mma() says so.
#pragma once
#include <cuda_runtime.h>

namespace hm {

// The bf16 shapes the tensor-core body takes: T a multiple of 16 up to
// 128 (one warp per 16 query rows), d a multiple of 16 up to 64, at
// most 320 keys.  Everything else, and float32, stays on the fp32 body.
bool shape_takes_mma(int nj, int t, int d);

// q/out (N, Wn, T, C) bf16; k, v: (N, J, Wn, T, .) bf16 with token rows
// kv_stride elements apart (2C and v = k + C for [K | V] rows, C for
// separate tensors); w_att, w_msg (N, J, heads, d, d) bf16 or both null
// (untyped); bias (heads, T, T) f32; mask (N, J, Wn, T) f32.  Every
// pointer 16-byte aligned (the copies are 16-byte cp.async).  Returns a cudaError_t.
int launch_window_attention_mma(const void* q, const void* k, const void* v,
                                long long kv_stride, const void* w_att,
                                const void* w_msg, const void* bias,
                                const void* mask, void* out, int n, int nj,
                                int nwin, int t, int heads, int d,
                                cudaStream_t stream);

}  // namespace hm
