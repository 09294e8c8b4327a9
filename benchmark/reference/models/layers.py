"""Shared building blocks (port of ``hmvit_tpu/models/layers.py``).

All feature maps are NHWC.  The hetero-typed primitives keep the
modality ("type") axis in front of their parameters, exactly as the
JAX package stores them, and select by the per-agent mode tensor (or by
a static fleet layout) instead of routing rows through per-type
submodules.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import (
    BatchNorm,
    Conv,
    ConvTranspose,
    Dropout,
    gelu,
    resize_nearest,
    uniform_,
    update_running_stats,
)


class ConvBNReLU(nn.Module):
    """Conv (symmetric k//2 padding) + BatchNorm (eps 1e-3, momentum
    0.99) + ReLU."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1, use_bias: bool = False,
                 bn_eps: float = 1e-3):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, padding=kernel // 2,
                           use_bias=use_bias)
        self.BatchNorm_0 = BatchNorm(features, bn_eps)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class NaiveDecoder(nn.Module):
    """Conv-BN-ReLU (x2 per level, walked coarse to fine) with optional
    nearest x2 upsampling after each level's first block."""

    def __init__(self, cin: int, num_layer: int, num_ch_dec: Sequence[int],
                 use_upsample: bool = True, bn_eps: float = 1e-3):
        super().__init__()
        self.use_upsample = use_upsample
        self.blocks = []
        k = 0
        for i in range(num_layer - 1, -1, -1):
            ch = num_ch_dec[i]
            for _ in range(2):
                blk = ConvBNReLU(cin, ch, bn_eps=bn_eps)
                self.add_module(f"ConvBNReLU_{k}", blk)
                self.blocks.append(blk)
                cin = ch
                k += 1

    def forward(self, x):
        for k, blk in enumerate(self.blocks):
            x = blk(x)
            if self.use_upsample and k % 2 == 0:
                x = resize_nearest(x, (x.shape[1] * 2, x.shape[2] * 2))
        return x


class NaiveCompressor(nn.Module):
    """Channel-bottleneck autoencoder that simulates a V2V bandwidth
    limit: conv-BN-ReLU to ``input_dim // compress_ratio`` channels and
    back, then one more at ``input_dim`` (the convs with bias)."""

    def __init__(self, input_dim: int, compress_ratio: int):
        super().__init__()
        mid = input_dim // compress_ratio
        self.ConvBNReLU_0 = ConvBNReLU(input_dim, mid, use_bias=True)
        self.ConvBNReLU_1 = ConvBNReLU(mid, input_dim, use_bias=True)
        self.ConvBNReLU_2 = ConvBNReLU(input_dim, input_dim, use_bias=True)

    def forward(self, x):
        return self.ConvBNReLU_2(self.ConvBNReLU_1(self.ConvBNReLU_0(x)))


class AutoEncoder(nn.Module):
    """Strided conv autoencoder compressor: two stride-2 conv-BN-ReLUs to
    ``input_dim // compress_ratio`` channels (a 4x spatial squeeze), then
    two 2x2 / 2 transposed convs with ReLU back to ``input_dim``."""

    def __init__(self, input_dim: int, compress_ratio: int = 4):
        super().__init__()
        ch = input_dim // compress_ratio
        self.ConvBNReLU_0 = ConvBNReLU(input_dim, ch, stride=2, use_bias=True)
        self.ConvBNReLU_1 = ConvBNReLU(ch, ch, stride=2, use_bias=True)
        self.ConvTranspose_0 = ConvTranspose(ch, ch, 2, 2, use_bias=True)
        self.ConvTranspose_1 = ConvTranspose(ch, input_dim, 2, 2,
                                             use_bias=True)

    def forward(self, x):
        h = self.ConvBNReLU_1(self.ConvBNReLU_0(x))
        h = F.relu(self.ConvTranspose_0(h))
        return F.relu(self.ConvTranspose_1(h))


class DoubleConv(nn.Module):
    def __init__(self, cin: int, features: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, features, kernel, stride, padding=kernel // 2)
        self.Conv_1 = Conv(features, features, 3)

    def forward(self, x):
        return F.relu(self.Conv_1(F.relu(self.Conv_0(x))))


class DownsampleConv(nn.Module):
    """Shrink head: stacked strided DoubleConvs."""

    def __init__(self, cin: int, kernel_sizes, dims, strides):
        super().__init__()
        self.blocks = []
        for i, (k, d, s) in enumerate(zip(kernel_sizes, dims, strides)):
            blk = DoubleConv(cin, d, kernel=k, stride=s)
            self.add_module(f"DoubleConv_{i}", blk)
            self.blocks.append(blk)
            cin = d

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class DetectionHead(nn.Module):
    """1x1 conv anchor heads -> (psm, rm); the classification bias
    starts at the focal-loss prior -log((1 - p) / p), p = 0.01."""

    def __init__(self, cin: int, anchor_number: int,
                 prior_prob: float = 0.01):
        super().__init__()
        self.prior_prob = prior_prob
        self.Conv_0 = Conv(cin, anchor_number, 1)
        self.Conv_1 = Conv(cin, 7 * anchor_number, 1)

    def reset_parameters(self, gen):
        with torch.no_grad():
            self.Conv_0.bias.fill_(
                -math.log((1.0 - self.prior_prob) / self.prior_prob))

    def forward(self, x):
        return self.Conv_0(x), self.Conv_1(x)


class MaskedBatchNorm(nn.Module):
    """Point-axis BatchNorm, eps 1e-3:
    ``(x - mean) * rsqrt(var + eps) * scale + bias``.  In eval mode mean
    and var are the running statistics; in train mode those of the rows
    ``mask`` marks (over the data axis under data parallelism), in ``x``'s
    type (bfloat16 under half precision), the variance in two passes, and
    the running statistics move by flax's rule with momentum 0.99."""
    flax_leaves = {"weight": ("params", "scale", "copy"),
                   "bias": ("params", "bias", "copy"),
                   "running_mean": ("batch_stats", "mean", "copy"),
                   "running_var": ("batch_stats", "var", "copy")}

    def __init__(self, c: int, epsilon: float = 1e-3,
                 momentum: float = 0.99):
        super().__init__()
        self.epsilon, self.momentum = epsilon, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def reset_parameters(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x, mask=None):
        """x (..., C); mask broadcastable to x[..., 0], read in train
        mode only."""
        if self.training:
            m = mask[..., None].to(x.dtype)
            axes = tuple(range(x.ndim - 1))
            denom = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(axes) / denom
            var = (((x - mean) ** 2) * m).sum(axes) / denom
            update_running_stats(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.weight + self.bias


def hetero_param_gather(params, mode):
    """(T, ...) stacked weights gathered by (B, L) mode -> (B, L, ...)."""
    return params[mode.long()]


class HeteroDense(nn.Module):
    """Per-modality Dense: x (B, L, ..., din), mode (B, L) ->
    (B, L, ..., dout).  ``kernel`` (T, din, dout) and ``bias`` (T, dout)
    keep the JAX layout (type axis first)."""
    flax_leaves = {"kernel": ("params", "kernel", "copy"),
                   "bias": ("params", "bias", "copy")}

    def __init__(self, din: int, features: int, num_types: int = 2,
                 use_bias: bool = True):
        super().__init__()
        self.num_types = num_types
        self.kernel = nn.Parameter(torch.empty(num_types, din, features))
        self.bias = (nn.Parameter(torch.zeros(num_types, features))
                     if use_bias else None)

    def reset_parameters(self, gen):
        lim = 1.0 / math.sqrt(self.kernel.shape[1])
        uniform_(self.kernel, -lim, lim, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x, mode, static_modes: tuple | None = None,
                return_params: bool = False):
        """static_modes: per-agent type layout known ahead of time; each
        agent's rows then hit only its own type's kernel.
        return_params: return ``(kernel, bias)`` without computing."""
        if return_params:
            return self.kernel, self.bias
        t, feats = self.num_types, self.kernel.shape[-1]
        if static_modes is not None:
            if len(static_modes) != x.shape[1]:
                raise ValueError(f"static_modes {static_modes} vs "
                                 f"L={x.shape[1]}")
            kt = self.kernel.to(x.dtype)
            y = torch.stack([x[:, i] @ kt[int(m)]
                             for i, m in enumerate(static_modes)], dim=1)
        else:
            din = x.shape[-1]
            k2d = self.kernel.transpose(0, 1).reshape(din, t * feats).to(
                x.dtype)
            y_all = (x @ k2d).reshape(*x.shape[:-1], t, feats)
            sel = F.one_hot(mode.long(), t).to(x.dtype)
            sel = sel.reshape(*mode.shape, *(1,) * (x.ndim - 3), t, 1)
            y = (y_all * sel).sum(dim=-2)
        if self.bias is None:
            return y
        if static_modes is not None:
            b = torch.stack([self.bias[int(m)] for m in static_modes]
                            ).to(x.dtype)
            return y + b.reshape(1, len(static_modes), *(1,) * (x.ndim - 3),
                                 feats)
        b = hetero_param_gather(self.bias, mode).to(x.dtype)
        return y + b.reshape(b.shape[0], b.shape[1], *(1,) * (y.ndim - 3),
                             feats)


class HeteroLayerNorm(nn.Module):
    """LayerNorm with per-modality scale/bias: eps 1e-5 and single-pass
    moments ``E[x^2] - E[x]^2`` (clamped at 0)."""
    flax_leaves = {"scale": ("params", "scale", "copy"),
                   "bias": ("params", "bias", "copy")}

    def __init__(self, c: int, num_types: int = 2):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(num_types, c))
        self.bias = nn.Parameter(torch.zeros(num_types, c))

    def reset_parameters(self, gen):
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x, mode):
        c = x.shape[-1]
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        s = hetero_param_gather(self.scale, mode)
        b = hetero_param_gather(self.bias, mode)
        shape = (*mode.shape, *(1,) * (x.ndim - 3), c)
        return y * s.reshape(shape) + b.reshape(shape)


class HeteroFeedForward(nn.Module):
    """Dense - GELU (tanh) - Dense with per-modality weights, each Dense
    followed by dropout at ``dropout`` in train mode."""

    def __init__(self, din: int, hidden_dim: int, out_dim: int | None = None,
                 num_types: int = 2, dropout: float = 0.0):
        super().__init__()
        self.HeteroDense_0 = HeteroDense(din, hidden_dim, num_types)
        self.HeteroDense_1 = HeteroDense(
            hidden_dim, din if out_dim is None else out_dim, num_types)
        self.Dropout_0 = Dropout(dropout)
        self.Dropout_1 = Dropout(dropout)

    def forward(self, x, mode, static_modes: tuple | None = None):
        h = self.Dropout_0(gelu(self.HeteroDense_0(x, mode, static_modes)))
        return self.Dropout_1(self.HeteroDense_1(h, mode, static_modes))
