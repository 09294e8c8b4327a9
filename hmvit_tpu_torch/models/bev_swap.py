"""BEVSwap camera -> BEV encoder (port of ``hmvit_tpu/models/bev_swap.py``):
per-view conv features, resized onto the BEV token grid, fused across
the camera views by swap attention (local window, then grid; the view
axis in the agent slot, identity geometry: a learned view-to-BEV
transform), averaged over the views, then upsampled to the BEV plane."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Conv, Dense, LayerNorm, gelu, normal_, resize_nearest
from .cvt import backbone_name, make_image_backbone
from .fusion.swap import SwapAttention


def resize_bilinear(x, hw: tuple[int, int]):
    """``jax.image.resize(x, (n, h, w, c), "bilinear")`` on NHWC: a
    triangle kernel on half-pixel centres, widened by the scale and
    normalised over the taps inside the image when it shrinks
    (antialiased), the plain lerp with clamped edges when it grows."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear",
                      align_corners=False, antialias=True)
    return y.permute(0, 2, 3, 1)


class BEVSwapEncoder(nn.Module):
    """images (N, M, H, W, 3) -> BEV (N, S, S, out_dim), S = bev_size
    2^upsample; M is the config's ``num_cams`` (default 4: the view
    embedding has one row a camera)."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        dim = cfg.get("dim", 128)
        self.bev = cfg.get("bev_size", 32)
        out_dim = cfg.get("out_dim", 256)
        depth = cfg.get("num_blocks", 2)
        window = cfg.get("window", 4)
        self.num_cams = cfg.get("num_cams", 4)
        backbone = make_image_backbone(cfg)
        self.backbone_name = backbone_name(backbone)
        self.add_module(self.backbone_name, backbone)
        self.Dense_0 = Dense(backbone.picked_channels[-1], dim)
        self.view_embedding = nn.Parameter(
            torch.empty(1, self.num_cams, 1, 1, dim))
        dh = cfg.get("dim_head", min(32, dim))
        self.depth = depth
        for k in range(depth):
            for j, style in enumerate(("local", "grid")):
                self.add_module(f"SwapAttention_{2 * k + j}", SwapAttention(
                    dim, dim_head=dh, window=window, style=style))
            for i in range(3):
                self.add_module(f"LayerNorm_{3 * k + i}", LayerNorm(dim))
            # flax names the outer Dense of ``Dense(gelu(Dense(x)))`` first
            self.add_module(f"Dense_{2 * k + 1}", Dense(2 * dim, dim))
            self.add_module(f"Dense_{2 * k + 2}", Dense(dim, 2 * dim))
        self.up = cfg.get("upsample", 2)
        for k in range(self.up):
            self.add_module(f"Conv_{k}", Conv(dim, dim, 3))
        self.add_module(f"Conv_{self.up}", Conv(dim, out_dim, 1))

    def reset_parameters(self, gen):
        normal_(self.view_embedding, 0.02, gen)

    def forward(self, images, intrinsics, extrinsics):
        n, m = images.shape[:2]
        if m != self.num_cams:
            raise ValueError(f"BEVSwap built for num_cams={self.num_cams}, "
                             f"got {m} cameras")
        feats = getattr(self, self.backbone_name)(
            images.reshape(n * m, *images.shape[2:]))
        if isinstance(feats, list):
            feats = feats[-1]
        feats = resize_bilinear(feats, (self.bev, self.bev))
        x = self.Dense_0(feats).reshape(n, m, self.bev, self.bev, -1)
        x = x + self.view_embedding
        mask = torch.ones(x.shape[:4], dtype=x.dtype, device=x.device)
        for k in range(self.depth):
            for j in range(2):
                ln = getattr(self, f"LayerNorm_{3 * k + j}")
                x = x + getattr(self, f"SwapAttention_{2 * k + j}")(ln(x),
                                                                   mask)
            hidden = getattr(self, f"Dense_{2 * k + 2}")(
                getattr(self, f"LayerNorm_{3 * k + 2}")(x))
            x = x + getattr(self, f"Dense_{2 * k + 1}")(gelu(hidden))
        x = x.mean(dim=1)  # fuse the views
        for k in range(self.up):
            x = resize_nearest(x, (x.shape[1] * 2, x.shape[2] * 2))
            x = torch.relu(getattr(self, f"Conv_{k}")(x))
        return getattr(self, f"Conv_{self.up}")(x)
