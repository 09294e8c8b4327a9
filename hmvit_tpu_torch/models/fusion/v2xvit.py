"""Per-agent window self-attention with relative position bias (port of
``WindowSelfAttention`` in ``hmvit_tpu/models/fusion/v2xvit.py``).  On
CUDA tensors it is the single-sender case of the plain window attention
kernel; on CPU tensors the JAX package's dense einsum path."""
from __future__ import annotations

import torch
from torch import nn

from ...nn import Dense, normal_
from ...ops import use_kernel
from ...ops.window_attention import fused_plain_window_attention
from ..hetero_fusion import _window_merge, _window_split, \
    relative_position_index


class WindowSelfAttention(nn.Module):
    def __init__(self, dim: int, window: int, heads: int = 8):
        super().__init__()
        self.dim, self.window, self.heads = dim, window, heads
        self.Dense_0 = Dense(dim, 3 * dim, use_bias=False)
        self.Dense_1 = Dense(dim, dim)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.register_buffer(
            "rel_index",
            torch.as_tensor(relative_position_index(window), dtype=torch.long),
            persistent=False)

    def reset_parameters(self, gen):
        normal_(self.rel_pos_bias, 0.02, gen)

    def forward(self, x):
        """x (B, L, H, W, C) -> (B, L, H, W, C)."""
        b, l, h, w, c = x.shape
        d = self.dim // self.heads
        win = self.window
        qkv = self.Dense_0(x)
        qw = _window_split(qkv[..., :c], win, "local")
        kvw = _window_split(qkv[..., c:], win, "local")
        nx, ny, t = qw.shape[2], qw.shape[3], win * win
        bias_h = self.rel_pos_bias[self.rel_index].permute(2, 0, 1)
        if use_kernel(qw):
            out = fused_plain_window_attention(
                (qw * d ** -0.5).reshape(b * l, nx * ny, t, c),
                kvw.reshape(b * l, 1, nx * ny, t, 2 * c), bias_h,
                torch.ones((b * l, 1, nx * ny, t), dtype=qw.dtype,
                           device=qw.device),
                self.heads, d,
            ).reshape(b, l, nx, ny, t, c)
        else:
            def heads_split(z):
                return z.reshape(b, l, nx, ny, t, self.heads, d)

            f32 = torch.float32
            qh = heads_split(qw) * d ** -0.5
            kh = heads_split(kvw[..., :c])
            vh = heads_split(kvw[..., c:])
            sim = torch.einsum("blxyihd,blxyjhd->blxyhij", qh.to(f32),
                               kh.to(f32))
            sim = sim + bias_h[None, None, None, None]
            attn = torch.softmax(sim, dim=-1)
            out = torch.einsum("blxyhij,blxyjhd->blxyihd", attn, vh.to(f32))
            out = out.reshape(b, l, nx, ny, t, self.heads * d)
        out = _window_merge(out, win, "local", h, w)
        return self.Dense_1(out)
