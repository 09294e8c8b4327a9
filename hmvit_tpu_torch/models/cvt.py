"""Cross-view transformer: multi-camera images -> BEV features (port of
``hmvit_tpu/models/cvt.py``).

A learned BEV query grid cross-attends over every camera's image tokens,
whose positional embedding is built from the pixel rays unprojected by
K^-1 and rotated into the agent frame by E^-1, plus the camera centre;
a conv decoder upsamples the BEV to the detection resolution.  Images
are NHWC, as everywhere in the port.  The geometry is float32 whatever
the images' type: the inverses are float32 ``torch.linalg.inv_ex`` and the
3 x 3 products are written out elementwise (exact float32, as the JAX
package's ``Precision.HIGHEST`` einsums, never TF32).
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import Dense, LayerNorm, gelu, normal_
from .layers import ConvBNReLU, NaiveDecoder
from .resnet import ResNetEncoder
from .vovnet import VoVNet


class ImageEncoder(nn.Module):
    """Small strided conv backbone: (N, H, W, 3) -> (N, H / 2^depth,
    W / 2^depth, channels[-1])."""

    def __init__(self, channels=(32, 64, 128, 256)):
        super().__init__()
        self.blocks = []
        cin = 3
        for k, ch in enumerate(channels):
            for j, stride in enumerate((2, 1)):
                blk = ConvBNReLU(cin, ch, stride=stride)
                self.add_module(f"ConvBNReLU_{2 * k + j}", blk)
                self.blocks.append(blk)
                cin = ch
        self.picked_channels = [cin]
        self.halvings = len(channels)

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


def make_image_backbone(cfg: dict) -> nn.Module:
    """The image backbone ``cfg["backbone"]`` names (``vovnet-19/39/57``
    or ``resnet18/34/50``, the ResNet with ``stem_s2d``; ``id_pick``
    picks the stages, stage 3 by default), else the plain strided conv
    encoder of ``encoder_channels``.  Every backbone has
    ``picked_channels`` (the channels of each picked output) and
    ``halvings`` (of the last one), and its flax name is its class's."""
    backbone = cfg.get("backbone")
    if not backbone:
        return ImageEncoder(tuple(cfg.get(
            "encoder_channels", (32, 64, 128, cfg.get("dim", 128)))))
    id_pick = tuple(cfg.get("id_pick", (3,)))
    if backbone.startswith("vovnet"):
        return VoVNet(arch=backbone, id_pick=id_pick)
    return ResNetEncoder(arch=backbone, id_pick=id_pick,
                         stem_s2d=cfg.get("stem_s2d", False))


def backbone_name(backbone: nn.Module) -> str:
    """The flax module name of a backbone made by
    :func:`make_image_backbone`: ``ImageEncoder_0``, ``ResNetEncoder_0`` or
    ``VoVNet_0``."""
    return f"{type(backbone).__name__}_0"


def single_output_channels(backbone: nn.Module, encoder: str) -> int:
    """The channels of a backbone that must return one map."""
    if len(backbone.picked_channels) != 1:
        raise ValueError(f"the {encoder} encoder takes one backbone stage "
                         f"(id_pick {backbone.id_pick})")
    return backbone.picked_channels[0]


def _matvec(m, v):
    """(..., 3, 3) x (..., 3) -> (..., 3), elementwise in the operands'
    type (no matmul backend, so no TF32)."""
    return (m * v[..., None, :]).sum(-1)


def _inv(m):
    """float32 inverse that does not raise on a singular matrix (the zero
    calibration of a padded slot), as ``jnp.linalg.inv`` does not: its
    entries are then not finite."""
    return torch.linalg.inv_ex(m.to(torch.float32))[0]


def pixel_rays(intrinsics, h: int, w: int, img_h: int, img_w: int):
    """K^-1 [u, v, 1] at the feature resolution, pixel centres at +0.5:
    intrinsics (..., 3, 3) of (img_h, img_w) images -> (..., h, w, 3)
    float32 camera-frame rays, not normalised."""
    dev = intrinsics.device
    sx, sy = img_w / w, img_h / h
    us = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) * sx
    vs = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) * sy
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    pix = torch.stack([uu, vv, torch.ones_like(uu)], dim=-1)  # (h, w, 3)
    k_inv = _inv(intrinsics)
    lead = k_inv.shape[:-2]
    return _matvec(k_inv.reshape(*lead, 1, 1, 3, 3), pix)


def view_directions(intrinsics, extrinsics, h: int, w: int, img_h: int,
                    img_w: int):
    """Unit pixel rays in the agent frame, and the inverse extrinsics:
    intrinsics (N, M, 3, 3), extrinsics (N, M, 4, 4 camera -> agent) ->
    ((N M, h, w, 3) float32 directions E^-1[:3, :3] K^-1 [u, v, 1] over
    their norm + 1e-6, (N M, 4, 4) float32 E^-1)."""
    nm = intrinsics.shape[0] * intrinsics.shape[1]
    rays = pixel_rays(intrinsics.reshape(nm, 3, 3), h, w, img_h, img_w)
    rot = _inv(extrinsics.reshape(nm, 4, 4))
    dirs = _matvec(rot[:, None, None, :3, :3], rays)
    dirs = dirs / (torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
                   + 1e-6)
    return dirs, rot


class CrossViewAttention(nn.Module):
    """BEV queries attend over every camera's image tokens (global); the
    scores, softmax and weighted sum in float32."""

    def __init__(self, dim: int, heads: int = 4, qkv_bias: bool = True):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.Dense_0 = Dense(dim, dim, use_bias=qkv_bias)
        self.Dense_1 = Dense(dim, dim, use_bias=qkv_bias)
        self.Dense_2 = Dense(dim, dim, use_bias=qkv_bias)
        self.Dense_3 = Dense(dim, dim)

    def forward(self, bev_q, img_tokens):
        """bev_q (N, Q, C), img_tokens (N, S, C) -> (N, Q, C)."""
        d = self.dim // self.heads

        def split(x):
            return x.reshape(*x.shape[:-1], self.heads, d)

        q = split(self.Dense_0(bev_q)) * d ** -0.5
        k = split(self.Dense_1(img_tokens))
        v = split(self.Dense_2(img_tokens))
        f32 = torch.float32
        # bf16 x bf16 products are exact in float32: the widened
        # operands give the float32-accumulated product
        sim = torch.einsum("nqhd,nshd->nhqs", q.to(f32), k.to(f32))
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("nhqs,nshd->nqhd", attn, v.to(f32))
        return self.Dense_3(out.reshape(*out.shape[:-2], self.dim))


class CVTBlock(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.CrossViewAttention_0 = CrossViewAttention(dim, heads)
        self.LayerNorm_0 = LayerNorm(dim)
        self.Dense_0 = Dense(dim, dim * 2)
        self.LayerNorm_1 = LayerNorm(dim)
        self.Dense_1 = Dense(dim * 2, dim)

    def forward(self, bev_q, img_tokens):
        x = bev_q + self.CrossViewAttention_0(self.LayerNorm_0(bev_q),
                                              img_tokens)
        h = self.Dense_0(self.LayerNorm_1(x))
        return x + self.Dense_1(gelu(h))


class CrossViewTransformer(nn.Module):
    """(N, M, H, W, 3) images + intrinsics (N, M, 3, 3) + extrinsics
    (N, M, 4, 4) -> (N, bev * 2^decoder_layers, ..., out_dim) BEV."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        self.cfg = cfg
        dim = cfg.get("dim", 128)
        self.dim = dim
        self.bev_hw = cfg.get("bev_size", 32)
        out_dim = cfg.get("out_dim", 256)
        backbone = make_image_backbone(cfg)
        feat_dim = single_output_channels(backbone, "CVT")
        self.backbone_name = backbone_name(backbone)
        self.add_module(self.backbone_name, backbone)
        self.Dense_0 = Dense(feat_dim, dim)
        # image embedding: Dense_1(gelu(Dense_2(dirs))); camera embedding:
        # Dense_3(gelu(Dense_4(centre))) (flax names the outer Dense
        # first)
        self.Dense_1 = Dense(dim, dim)
        self.Dense_2 = Dense(3, dim)
        self.Dense_3 = Dense(dim, dim)
        self.Dense_4 = Dense(3, dim)
        self.bev_embedding = nn.Parameter(
            torch.empty(self.bev_hw, self.bev_hw, dim))
        self.blocks = []
        for k in range(cfg.get("num_blocks", 2)):
            blk = CVTBlock(dim)
            self.add_module(f"CVTBlock_{k}", blk)
            self.blocks.append(blk)
        self.Dense_5 = Dense(dim, out_dim)
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

        dirs, rot = view_directions(intrinsics, extrinsics, fh, fw, img_h,
                                    img_w)
        img_embed = self.Dense_1(gelu(self.Dense_2(dirs)))
        cam_embed = self.Dense_3(gelu(self.Dense_4(rot[:, :3, 3])))
        tokens = (feats + img_embed + cam_embed[:, None, None]).reshape(
            n, m * fh * fw, dim)

        bev_q = self.bev_embedding.reshape(1, -1, dim).expand(
            n, self.bev_hw * self.bev_hw, dim)
        for blk in self.blocks:
            bev_q = blk(bev_q, tokens)
        bev = self.Dense_5(bev_q.reshape(n, self.bev_hw, self.bev_hw, dim))
        return self.NaiveDecoder_0(bev)
