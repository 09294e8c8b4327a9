"""FAX / SinBEVT camera -> BEV encoder: windowed cross-view attention
(port of ``hmvit_tpu/models/fax.py``).

A learned BEV prior is refined by blocks of (a) local-window attention,
each BEV window attending to the co-located window of every camera's
features, and (b) its grid (dilated) variant, the windows split as the
fusion stage splits them.  The cameras are folded into the key token
axis: one softmax over every camera's window tokens.  The image tokens
carry an embedding of their pixel rays rotated into the agent frame
(float32 geometry, as in the cross-view transformer).  Plain PyTorch:
the JAX package runs these einsums through XLA, no Pallas kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import Dense, LayerNorm, gelu, normal_
from .cvt import (
    backbone_name,
    make_image_backbone,
    single_output_channels,
    view_directions,
)
from .hetero_fusion import _window_merge, _window_split
from .layers import NaiveDecoder


class CrossWinAttention(nn.Module):
    """BEV window queries x every camera's co-located window of image
    tokens; scores, softmax and weighted sum in float32."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 style: str = "local", bev_win: int = 4):
        super().__init__()
        self.heads, self.dim_head, self.style = heads, dim_head, style
        self.bev_win = bev_win
        inner = heads * dim_head
        self.Dense_0 = Dense(dim, inner, use_bias=False)
        self.Dense_1 = Dense(dim, inner, use_bias=False)
        self.Dense_2 = Dense(dim, inner, use_bias=False)
        self.Dense_3 = Dense(inner, dim)

    def forward(self, bev_q, img_kv, img_win: int):
        """bev_q (N, Hb, Wb, C), img_kv (N, M, Hi, Wi, C) -> (N, Hb, Wb, C);
        the image windows of ``img_win`` must tile the same grid as the
        BEV windows."""
        n, hb, wb, _ = bev_q.shape
        m = img_kv.shape[1]
        h, d = self.heads, self.dim_head
        qw = _window_split(self.Dense_0(bev_q), self.bev_win, self.style)
        kw = _window_split(self.Dense_1(img_kv), img_win, self.style)
        vw = _window_split(self.Dense_2(img_kv), img_win, self.style)
        x_w, y_w, tq = qw.shape[1:4]
        tk = kw.shape[4]
        qh = qw.reshape(n, x_w, y_w, tq, h, d) * d ** -0.5
        kh = kw.reshape(n, m, x_w, y_w, tk, h, d)
        vh = vw.reshape(n, m, x_w, y_w, tk, h, d)
        f32 = torch.float32
        # bf16 x bf16 products are exact in float32: the widened operands
        # give the float32-accumulated product
        sim = torch.einsum("nxyqhd,nmxykhd->nxyhqmk", qh.to(f32), kh.to(f32))
        attn = torch.softmax(sim.reshape(n, x_w, y_w, h, tq, m * tk),
                             dim=-1).reshape(sim.shape)
        out = torch.einsum("nxyhqmk,nmxykhd->nxyqhd", attn, vh.to(f32))
        out = out.reshape(n, x_w, y_w, tq, h * d)
        return self.Dense_3(_window_merge(out, self.bev_win, self.style, hb,
                                          wb))


class FAXBlock(nn.Module):
    """Local then grid cross-window attention, each followed by a GELU
    feed-forward, pre-norm residual (LayerNorm eps 1e-6)."""

    STYLES = ("local", "grid")

    def __init__(self, dim: int, heads: int, dim_head: int, bev_win: int):
        super().__init__()
        for k, style in enumerate(self.STYLES):
            self.add_module(f"CrossWinAttention_{k}", CrossWinAttention(
                dim, heads, dim_head, style, bev_win))
            self.add_module(f"LayerNorm_{2 * k}", LayerNorm(dim))
            self.add_module(f"LayerNorm_{2 * k + 1}", LayerNorm(dim))
            # flax names the outer Dense of ``Dense(gelu(Dense(x)))`` first
            self.add_module(f"Dense_{2 * k}", Dense(2 * dim, dim))
            self.add_module(f"Dense_{2 * k + 1}", Dense(dim, 2 * dim))

    def forward(self, bev, img_feats, img_win: int):
        for k in range(len(self.STYLES)):
            attend = getattr(self, f"CrossWinAttention_{k}")
            bev = bev + attend(getattr(self, f"LayerNorm_{2 * k}")(bev),
                               img_feats, img_win)
            hidden = getattr(self, f"Dense_{2 * k + 1}")(
                getattr(self, f"LayerNorm_{2 * k + 1}")(bev))
            bev = bev + getattr(self, f"Dense_{2 * k}")(gelu(hidden))
        return bev


class FAXCameraEncoder(nn.Module):
    """(N, M, H, W, 3) images + intrinsics (N, M, 3, 3) + extrinsics
    (N, M, 4, 4) -> (N, bev * 2^decoder_layers, ..., out_dim) BEV."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        dim = cfg.get("dim", 128)
        self.dim = dim
        self.bev_hw = cfg.get("bev_size", 32)
        self.bev_win = cfg.get("bev_window", 4)
        out_dim = cfg.get("out_dim", 256)
        heads = cfg.get("heads", 4)
        dim_head = cfg.get("dim_head", 32)
        backbone = make_image_backbone(cfg)
        feat_dim = single_output_channels(backbone, "FAX")
        self.backbone_name = backbone_name(backbone)
        self.add_module(self.backbone_name, backbone)
        self.Dense_0 = Dense(feat_dim, dim)
        # ray embedding Dense_1(gelu(Dense_2(dirs))), the outer named first
        self.Dense_1 = Dense(dim, dim)
        self.Dense_2 = Dense(3, dim)
        self.bev_embedding = nn.Parameter(
            torch.empty(self.bev_hw, self.bev_hw, dim))
        self.blocks = []
        for k in range(cfg.get("depth", 2)):
            blk = FAXBlock(dim, heads, dim_head, self.bev_win)
            self.add_module(f"FAXBlock_{k}", blk)
            self.blocks.append(blk)
        self.Dense_3 = Dense(dim, out_dim)
        up = cfg.get("decoder_layers", 2)
        self.NaiveDecoder_0 = NaiveDecoder(out_dim, up, [out_dim] * up,
                                           use_upsample=True)

    def reset_parameters(self, gen):
        normal_(self.bev_embedding, 0.02, gen)

    def forward(self, images, intrinsics, extrinsics):
        n, m, img_h, img_w, _ = images.shape
        dim = self.dim
        feats = getattr(self, self.backbone_name)(
            images.reshape(n * m, img_h, img_w, 3))
        fh, fw = feats.shape[1:3]
        feats = self.Dense_0(feats)
        dirs, _ = view_directions(intrinsics, extrinsics, fh, fw, img_h,
                                  img_w)
        feats = feats + self.Dense_1(gelu(self.Dense_2(dirs)))
        feats = feats.reshape(n, m, fh, fw, dim)
        bev = self.bev_embedding[None].expand(n, self.bev_hw, self.bev_hw,
                                              dim)
        # the image windows tile the feature map as many times as the BEV
        # windows tile the BEV grid
        img_win = fh // (self.bev_hw // self.bev_win)
        for blk in self.blocks:
            bev = blk(bev, feats, img_win)
        return self.NaiveDecoder_0(self.Dense_3(bev))
