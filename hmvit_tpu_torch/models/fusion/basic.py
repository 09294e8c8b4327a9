"""Simple cooperative fusions (port of
``hmvit_tpu/models/fusion/basic.py``): per-pixel max (F-Cooper), agent
attention, DiscoNet.

Each warps every agent's map into the ego (slot 0) frame, or, DiscoNet,
into its receivers' frames, and fuses along the agent axis with the
padded slots masked.  Plain PyTorch, as the JAX package's XLA ops.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...nn import BatchNorm, Conv, Dense
from ...ops.warp import warp_bev_nhwc
from ..hetero_fusion import pairwise_roi_mask


def warp_to_ego(x, pairwise, discrete_ratio, downsample_rate):
    """(B, L, H, W, C) -> every agent's map in the ego frame."""
    return warp_bev_nhwc(x, pairwise[:, :, 0], discrete_ratio,
                         downsample_rate)


class SpatialFusion(nn.Module):
    """F-Cooper: per-pixel max over the live agents (-inf on the padded
    slots, 0 where no agent is live)."""

    def __init__(self, discrete_ratio: float = 0.4,
                 downsample_rate: float = 4.0):
        super().__init__()
        self.discrete_ratio, self.downsample_rate = (discrete_ratio,
                                                     downsample_rate)

    def forward(self, x, mode, pairwise, agent_mask):
        x = warp_to_ego(x, pairwise, self.discrete_ratio,
                        self.downsample_rate)
        neg = torch.where(agent_mask[:, :, None, None, None] > 0, x,
                          float("-inf"))
        out = neg.amax(dim=1)
        return torch.where(torch.isfinite(out), out, 0.0)


class AttFusion(nn.Module):
    """Per-pixel scaled dot-product attention along the agent axis, the
    ego's row the query (q = k = v = the warped maps), float32 scores
    and output."""

    def __init__(self, dim: int, discrete_ratio: float = 0.4,
                 downsample_rate: float = 4.0):
        super().__init__()
        self.discrete_ratio, self.downsample_rate = (discrete_ratio,
                                                     downsample_rate)

    def forward(self, x, mode, pairwise, agent_mask):
        x = warp_to_ego(x, pairwise, self.discrete_ratio,
                        self.downsample_rate).to(torch.float32)
        sim = torch.einsum("bhwc,blhwc->blhw", x[:, 0], x)
        sim = sim / math.sqrt(x.shape[-1])
        sim = torch.where(agent_mask[:, :, None, None] > 0, sim, -1e9)
        return torch.einsum("blhw,blhwc->bhwc", torch.softmax(sim, dim=1), x)


class PixelWeightedFusionSoftmax(nn.Module):
    """(neighbour, receiver) pair scorer: three 1x1 conv + BatchNorm (eps
    1e-5, momentum 0.9) + ReLU, 2C -> 128 -> 32 -> 8, then a bare 1x1 ->
    1 + ReLU.  Its BatchNorms always normalise with their running
    statistics: no caller of the JAX package passes ``train`` to the
    DiscoNet fusion, so the JAX model keeps them in inference mode while
    it trains (this module stays in eval mode under ``train()``)."""

    def __init__(self, cin: int):
        super().__init__()
        for i, ch in enumerate((128, 32, 8)):
            self.add_module(f"Conv_{i}", Conv(cin, ch, 1))
            self.add_module(f"BatchNorm_{i}", BatchNorm(ch, 1e-5, 0.9))
            cin = ch
        self.Conv_3 = Conv(cin, 1, 1)
        super().train(False)

    def train(self, mode: bool = True):
        return super().train(False)

    def forward(self, pair):
        x = pair
        for i in range(3):
            x = F.relu(getattr(self, f"BatchNorm_{i}")(
                getattr(self, f"Conv_{i}")(x)))
        return F.relu(self.Conv_3(x))


class DiscoNetFusion(nn.Module):
    """Pixel-weighted softmax fusion: per receiver, every agent's map is
    warped into the receiver's frame, each (warped neighbour, receiver)
    pair scored by the shared :class:`PixelWeightedFusionSoftmax`,
    masked to the pair's ROI and agent overlap, softmaxed over the agent
    axis and summed; the ego's fused map goes through a per-pixel Dense.
    With ``num_iteration`` 1 only the ego receiver is computed (the
    others' updates are never read)."""

    def __init__(self, dim: int, discrete_ratio: float = 0.4,
                 downsample_rate: float = 4.0, num_iteration: int = 1,
                 use_mask: bool = True):
        super().__init__()
        self.discrete_ratio, self.downsample_rate = (discrete_ratio,
                                                     downsample_rate)
        self.num_iteration, self.use_mask = num_iteration, use_mask
        self.pixel_weighted_fusion = PixelWeightedFusionSoftmax(2 * dim)
        self.mlp = Dense(dim, dim)

    def forward(self, x, mode, pairwise, agent_mask):
        b, l, h, w, c = x.shape
        geo = (self.discrete_ratio, self.downsample_rate)
        roi = pairwise_roi_mask(pairwise, agent_mask, (h, w), *geo)
        n_recv = l if self.num_iteration > 1 else 1
        m_ij = roi[:, :n_recv].movedim(-1, 2)  # (B, I, J, H, W)
        t_ij = pairwise.transpose(1, 2)[:, :n_recv]  # (B, I, J, 4, 4)
        shape = (b, n_recv, l, h, w, c)
        feats, fused = x, x[:, :n_recv]
        for _ in range(self.num_iteration):
            src = feats[:, None].expand(shape)
            warped = warp_bev_nhwc(
                src.reshape(b * n_recv, l, h, w, c),
                t_ij.reshape(b * n_recv, l, 4, 4), *geo).reshape(shape)
            recv = feats[:, :n_recv, None].expand(shape)
            pair = torch.cat([warped, recv], dim=-1)
            s = self.pixel_weighted_fusion(
                pair.reshape(b * n_recv * l, h, w, 2 * c))
            s = s.reshape(b, n_recv, l, h, w)
            if self.use_mask:
                s = torch.where(m_ij > 0, s, float("-inf"))
            wgt = torch.softmax(s, dim=2)
            wgt = torch.where(torch.isfinite(wgt), wgt, 0.0)
            fused = (wgt[..., None] * warped * m_ij[..., None]).sum(dim=2)
            feats = fused if n_recv == l else torch.cat(
                [fused, feats[:, 1:]], dim=1)
        return self.mlp(fused[:, 0])
