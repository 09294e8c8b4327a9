"""VPN (View Parsing Network) camera -> BEV baseline (port of
``hmvit_tpu/models/vpn.py``; the ``vpn`` and ``vpn_ms`` encoders): each
camera's feature map is flattened and pushed through a learned
two-layer MLP over the token axis into BEV token space, the cameras'
BEVs are averaged, and a conv decoder refines.  No geometry.

The token-axis layers' widths are the feature map's token count, which
follows from the image size: the config's ``img_size`` (an int, or
[height, width]; the corpus's VPN configs carry it) and the backbone's
halvings (XLA 'SAME': each rounds up)."""
from __future__ import annotations

import torch
from torch import nn

from ..nn import Dense
from .cvt import backbone_name, make_image_backbone, single_output_channels
from .layers import NaiveDecoder


def feature_hw(img_hw, halvings: int) -> tuple[int, int]:
    """The (h, w) of a map halved ``halvings`` times, each rounding up."""
    h, w = img_hw
    for _ in range(halvings):
        h, w = -(-h // 2), -(-w // 2)
    return h, w


class ViewParseNetwork(nn.Module):
    """(N, M, H, W, 3) images -> (N, bev * 2^decoder_layers, ..., out_dim)
    BEV; H, W must be the config's ``img_size``."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        if "img_size" not in cfg:
            raise ValueError("the VPN camera encoder needs the image size "
                             "(camera config key img_size) to size its "
                             "token-axis layers")
        size = cfg["img_size"]
        self.img_hw = ((size, size) if isinstance(size, int)
                       else tuple(size))
        dim = cfg.get("dim", 128)
        self.dim = dim
        self.bev_hw = cfg.get("bev_size", 32)
        out_dim = cfg.get("out_dim", 256)
        backbone = make_image_backbone(cfg)
        feat_dim = single_output_channels(backbone, "VPN")
        self.backbone_name = backbone_name(backbone)
        self.add_module(self.backbone_name, backbone)
        fh, fw = feature_hw(self.img_hw, backbone.halvings)
        self.Dense_0 = Dense(feat_dim, dim)
        self.view_hidden = Dense(fh * fw, fh * fw)
        self.view_transform = Dense(fh * fw, self.bev_hw * self.bev_hw)
        self.Dense_1 = Dense(dim, out_dim)
        up = cfg.get("decoder_layers", 2)
        self.NaiveDecoder_0 = NaiveDecoder(out_dim, up, [out_dim] * up,
                                           use_upsample=True)

    def forward(self, images, intrinsics, extrinsics):
        n, m, img_h, img_w, _ = images.shape
        if (img_h, img_w) != self.img_hw:
            raise ValueError(f"VPN built for images of {self.img_hw} "
                             f"(img_size), got {(img_h, img_w)}")
        feats = self.Dense_0(getattr(self, self.backbone_name)(
            images.reshape(n * m, img_h, img_w, 3)))
        fh, fw = feats.shape[1:3]
        # image tokens -> BEV tokens, per camera, over the token axis
        tokens = feats.reshape(n * m, fh * fw, self.dim).transpose(1, 2)
        bev_tokens = self.view_transform(torch.relu(self.view_hidden(tokens)))
        bev = bev_tokens.transpose(1, 2).reshape(n, m, self.bev_hw,
                                                 self.bev_hw, self.dim)
        return self.NaiveDecoder_0(self.Dense_1(bev.mean(dim=1)))
