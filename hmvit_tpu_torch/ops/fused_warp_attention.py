"""Fused pair warp + local window attention (port of
``hmvit_tpu/ops/fused_warp_attention.py``).

:func:`fused_warp_window_attention` launches the CUDA kernel
``csrc/fused_warp_attention.cu`` for CUDA tensors (the replacement of
the Pallas ``_fused_kernel``): the attention output comes straight from
the typed sender maps, bit-identical to :func:`fused_pair_warp` followed
by :func:`fused_stripe_window_attention` — in bfloat16 on the tensor
cores, in float32 on the fp32 CUDA cores, by the rule of
:func:`hmvit_tpu_torch.ops.window_attention.attention_body` — and the
warped (N, J, H, W, 2C) tensor never reaches device memory.  For CPU
tensors, or under :func:`hmvit_tpu_torch.ops.plain_ops`, it runs
:func:`warp_window_attention_xla` — pair-warp twin, window split, plain
attention twin, merge: the JAX package's oracle.  The backward
recomputes through the twin and gives gradients for q, src_typed and
bias; the geometry and the 0/1 mask carry none.
"""
from __future__ import annotations

import torch

from . import cuda, opcount, use_kernel
from ..tracing import twin_backward
from .fused_warp import _prep_affines, pair_warp_xla
from .window_attention import (
    _recompute_grads,
    attention_body,
    stripe_window_attention_xla,
)


def warp_window_attention_xla(q, src_typed, pairwise, mode, mask, bias,
                              win: int, heads: int, dim_head: int,
                              discrete_ratio, downsample_rate,
                              num_receivers=None):
    """Plain twin.  q (B*I, H, W, C) pre-scaled queries; src_typed (B,
    TY, J, H, W, 2C) typed sender [K | V] maps; pairwise (B, L, L, 4, 4);
    mode (B, L) receiver variants; mask (B*I, J, H, W); bias (heads, T,
    T).  Returns (B*I, H, W, C)."""
    l, h, w, ck2 = src_typed.shape[2:]
    kv_pair = pair_warp_xla(src_typed, pairwise, mode, discrete_ratio,
                            downsample_rate, num_receivers)
    return stripe_window_attention_xla(
        q, kv_pair.reshape(q.shape[0], l, h, w, ck2), bias, mask, win,
        heads, dim_head)


def warp_window_attention_launch(q, src_typed, pairwise, mode, mask, bias,
                                 win, heads, dim_head, discrete_ratio,
                                 downsample_rate, num_receivers=None,
                                 coef=None, simt: bool = False):
    """Validate and lay out one fused launch: returns (launch, out).
    ``coef`` is the frame's ``pair_warp_coefficients`` of ``pairwise``,
    or None to compute them here.  The body follows the window attention
    kernels' rule (:func:`attention_body`); ``simt`` forces the fp32
    CUDA-core body where the entry point would choose the tensor cores
    (for timing only)."""
    bsz, ty_count, l, h, w, ck2 = src_typed.shape
    r = l if num_receivers is None else num_receivers
    c, t = heads * dim_head, win * win
    if q.dtype not in cuda.DTYPE_CODES or src_typed.dtype != q.dtype:
        raise TypeError(f"warp + attention: unsupported dtypes {q.dtype}/"
                        f"{src_typed.dtype}")
    if h * w * ck2 >= 2 ** 31:
        raise ValueError(f"warp + attention: a map of {h * w * ck2} "
                         f"elements, the kernel indexes maps in 32 bits")
    if h != w or h % win or dim_head % 8:
        raise ValueError(f"warp + attention needs square maps divisible by "
                         f"the window and dim_head % 8 == 0, got {(h, w)}, "
                         f"window {win}, d={dim_head}")
    if (ck2 != 2 * c or not 0 < r <= l
            or tuple(q.shape) != (bsz * r, h, w, c)
            or tuple(mask.shape) != (bsz * r, l, h, w)
            or tuple(bias.shape) != (heads, t, t)
            or tuple(pairwise.shape) != (bsz, l, l, 4, 4)
            or tuple(mode.shape) != (bsz, l)):
        raise ValueError(
            f"warp + attention: inconsistent shapes q {tuple(q.shape)}, src "
            f"{tuple(src_typed.shape)}, pairwise {tuple(pairwise.shape)}, "
            f"mode {tuple(mode.shape)}, mask {tuple(mask.shape)}, bias "
            f"{tuple(bias.shape)} for {r} receivers, {heads} heads of "
            f"{dim_head}")
    if coef is not None and (tuple(coef.shape) != (bsz, l, l, 8)
                             or coef.dtype != torch.float32):
        raise ValueError(f"warp + attention: coefficients "
                         f"{tuple(coef.shape)} {coef.dtype}, want "
                         f"({bsz}, {l}, {l}, 8) float32")
    attention_body(q.dtype, l, t, dim_head)
    coef, rtype = _prep_affines(pairwise, mode, (h, w), discrete_ratio,
                                downsample_rate, r, coef)
    # the kernel reads src[b, rtype[n]]: an out-of-range variant raises
    # (asynchronously, on the device) instead of reading past the map
    torch._assert_async(((rtype >= 0) & (rtype < ty_count)).all(),
                        "warp + attention: receiver variant out of range")
    tensors = [q.contiguous(), src_typed.contiguous(), coef, rtype,
               bias.to(torch.float32).contiguous(),
               mask.to(torch.float32).contiguous(), torch.empty_like(q)]
    ints = [cuda.DTYPE_CODES[q.dtype], bsz * r, l, ty_count, r, h, win,
            heads, dim_head]
    kernel = (cuda.WARP_WINDOW_ATTENTION_SIMT if simt
              else cuda.WARP_WINDOW_ATTENTION)
    return lambda: kernel.launch(tensors, ints), tensors[-1]


class _WarpWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, src_typed, bias, pairwise, mode, mask, coef, args):
        ctx.save_for_backward(q, src_typed, bias, pairwise, mode, mask)
        ctx.args = args
        launch, out = warp_window_attention_launch(
            q, src_typed, pairwise, mode, mask, bias, *args, coef)
        launch()
        return out

    @staticmethod
    def backward(ctx, g):
        q, src, bias, pairwise, mode, mask = ctx.saved_tensors
        with twin_backward("warp_window_attention"):
            grads = _recompute_grads(
                lambda q_, s_, b_: warp_window_attention_xla(
                    q_, s_, pairwise, mode, mask, b_, *ctx.args),
                (q, src, bias), g)
        return (*grads, None, None, None, None, None)


def fused_warp_window_attention(q, src_typed, pairwise, mode, mask, bias,
                                win: int, heads: int, dim_head: int,
                                discrete_ratio, downsample_rate,
                                num_receivers=None, coef=None):
    """CUDA kernel forward (plain-twin backward) for CUDA tensors; the
    plain twin for CPU tensors and under ``plain_ops()``.  Arguments as
    :func:`warp_window_attention_xla`; ``coef``, the frame's
    ``pair_warp_coefficients``, spares the kernel path its geometry."""
    args = (win, heads, dim_head, discrete_ratio, downsample_rate,
            num_receivers)
    n, h, w = q.shape[:3]
    j = src_typed.shape[2]
    opcount.note("warp_window_attention", opcount.attention_ops(
        n, (h // win) * (w // win), win * win, j, heads, dim_head)
        + opcount.pair_warp_ops(n, j, h, w, src_typed.shape[-1]))
    if use_kernel(q):
        return _WarpWindowAttention.apply(q, src_typed, bias, pairwise, mode,
                                          mask, coef, args)
    with opcount.hidden():
        return warp_window_attention_xla(q, src_typed, pairwise, mode, mask,
                                         bias, *args)
