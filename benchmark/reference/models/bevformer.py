"""BEVFormer-style camera -> BEV encoder by the planar lift (port of
``hmvit_tpu/models/bevformer.py``, its ``lift: planar`` path alone):
per layer, windowed BEV self-attention, then the planar-lift cross
attention — for each (camera, height plane) the BEV->image map is a
homography, so every query's projected reference point is sampled by one
dense separable projective warp, and per-query weights over the
(camera, plane) hypotheses reduce them — then a GELU feed-forward.  The
image features are one ResNet stage (``id_pick``), no FPN and no BEV
decoder: the configurations the benchmark runs.

LayerNorms use flax's eps 1e-6.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nn import DTYPES, Dense, LayerNorm, gelu, normal_
from ..ops.projective_warp import (
    projective_reduce_apply,
    projective_reduce_prepare,
)
from ..utils.constants import device_constant
from .hetero_fusion import (
    _window_merge,
    _window_split,
    relative_position_index,
)
from .resnet import ResNetEncoder

# CARLA/UE4 agent frame (x fwd, y right, z up) -> OpenCV camera axes
_UE4_TO_CV = ((0.0, 1.0, 0.0), (0.0, 0.0, -1.0), (1.0, 0.0, 0.0))


def lidar2img(intrinsics, cam_to_lidar):
    """(..., 3, 3), (..., 4, 4 cam->agent) -> (..., 3, 4) projection."""
    # inv_ex: the same inverse without inv's read-back of its error
    # status, which synchronises a CUDA device with the host
    rt = torch.linalg.inv_ex(cam_to_lidar.to(torch.float32))[0]  # agent -> cam
    ue = device_constant(_UE4_TO_CV, torch.float32, rt.device)
    rt_cv = torch.einsum("ij,...jk->...ik", ue, rt[..., :3, :])
    return torch.einsum("...ij,...jk->...ik",
                        intrinsics.to(torch.float32), rt_cv)


def planar_lift_prepare(cam_feats, proj, bev_range, z_values, img_hw,
                        bev_hw):
    """Layer-independent geometry and warp pass 1 of the planar lift:
    (camera, z-plane) homographies, hypothesis visibility and the
    projective-reduce prepass over the raw camera features."""
    n, m, fh, fw = cam_feats.shape[:4]
    z = z_values.shape[0]
    hb = wb = bev_hw
    img_h, img_w = img_hw
    step = 2 * bev_range / wb
    dev = cam_feats.device
    f32 = torch.float32

    # image pixels <- BEV pixels on z = z_k:
    # uvw = P @ [x, y, z_k, 1], [x, y] = step * [x', y'] + (step/2 - R)
    p = proj.to(f32)  # (N, M, 3, 4)
    col_x = p[..., 0] * step
    col_y = p[..., 1] * step
    off = (step / 2.0) - bev_range
    const = p[..., 0] * off + p[..., 1] * off + p[..., 3]  # (N, M, 3)
    const_k = (const[:, :, None, :]
               + p[..., 2][:, :, None, :] * z_values[None, None, :, None])
    h_img = torch.stack([col_x[:, :, None].expand(const_k.shape),
                         col_y[:, :, None].expand(const_k.shape),
                         const_k], dim=-1)  # (N, M, Z, 3, 3)
    scale = torch.diag(device_constant((fw / img_w, fh / img_h, 1.0), f32,
                                       dev))
    h_feat = torch.einsum("ij,nmkjl->nmkil", scale, h_img)

    ys = torch.arange(hb, dtype=f32, device=dev)[None, :, None]
    xs = torch.arange(wb, dtype=f32, device=dev)[None, None, :]
    hf = h_feat.reshape(-1, 3, 3)
    w_ = (hf[:, 2, 0, None, None] * xs + hf[:, 2, 1, None, None] * ys
          + hf[:, 2, 2, None, None])
    sw = torch.where(torch.abs(w_) < 1e-6, torch.full_like(w_, 1e-6), w_)
    u_ = (hf[:, 0, 0, None, None] * xs + hf[:, 0, 1, None, None] * ys
          + hf[:, 0, 2, None, None]) / sw
    v_ = (hf[:, 1, 0, None, None] * xs + hf[:, 1, 1, None, None] * ys
          + hf[:, 1, 2, None, None]) / sw
    vis = ((w_ > 0.1) & (u_ >= 0) & (u_ < fw)
           & (v_ >= 0) & (v_ < fh)).reshape(n, m, z, hb, wb)
    state = projective_reduce_prepare(
        cam_feats, h_feat.reshape(n, m * z, 3, 3), (hb, wb))
    return {"state": state, "vis": vis, "m": m, "z": z}


class PlanarLiftCrossAttention(nn.Module):
    """Per-query adaptive weights over the visible (camera, plane)
    hypotheses, folded into one fused projective warp-reduce; the value
    projection applies after the (linear) warp."""

    def __init__(self, dim: int, feat_dim: int, num_cams: int,
                 z_points: int = 4):
        super().__init__()
        self.hypo_weights = Dense(dim, num_cams * z_points)
        self.value = Dense(feat_dim, dim, use_bias=False)
        self.out = Dense(dim, dim)

    def forward(self, query_2d, prepared, compute_dtype):
        n, hb, wb, c = query_2d.shape
        vis = prepared["vis"]
        m, z = prepared["m"], prepared["z"]
        logits = self.hypo_weights(query_2d)
        logits = logits.reshape(n, hb, wb, m, z).permute(0, 3, 4, 1, 2)
        logits = torch.where(vis, logits,
                             torch.full((), -1e9, dtype=logits.dtype,
                                        device=logits.device))
        weights = torch.softmax(logits.reshape(n, m * z, hb, wb), dim=1)
        any_vis = vis.reshape(n, m * z, hb, wb).any(dim=1, keepdim=True)
        weights = torch.where(any_vis, weights, torch.zeros_like(weights))
        out = projective_reduce_apply(prepared["state"], weights)
        return self.out(self.value(out.to(compute_dtype)))


class BEVWindowSelfAttention(nn.Module):
    """Windowed BEV self-attention: the per-agent window attention with a
    singleton agent axis."""

    def __init__(self, dim: int, window: int = 8, heads: int = 8):
        super().__init__()
        self.WindowSelfAttention_0 = WindowSelfAttention(dim, window, heads)

    def forward(self, x):
        return self.WindowSelfAttention_0(x[:, None])[:, 0]


class WindowSelfAttention(nn.Module):
    """Per-agent window self-attention with a relative position bias
    (the port's ``models/fusion/v2xvit.py`` class, its plain path)."""

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


class BEVFormerEncoder(nn.Module):
    """(N, M, H, W, 3) images + calibration -> (N, out, out, out_dim) BEV
    by the planar lift.  The compute dtype follows the images unless the
    config names one."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        self.cfg = cfg
        if (cfg.get("lift", "planar") != "planar" or cfg.get("fpn")
                or cfg.get("decoder_layers", 0)
                or cfg.get("backbone", "resnet50").startswith("vovnet")
                or len(cfg.get("id_pick", (3,))) != 1):
            raise ValueError("the reference's BEVFormer is the planar lift "
                             "on one ResNet stage, no FPN, no decoder")
        dim = cfg.get("dim", 256)
        self.dim = dim
        self.bev_hw = cfg.get("bev_size", 128)
        out_dim = cfg.get("out_dim", 256)
        self.layers = cfg.get("num_layers", 3)
        heads = cfg.get("heads", 8)
        self.z_points = cfg.get("num_points_in_pillar", 4)
        self.ResNetEncoder_0 = backbone = ResNetEncoder(
            arch=cfg.get("backbone", "resnet50"),
            id_pick=tuple(cfg.get("id_pick", (3,))),
            stem_s2d=cfg.get("stem_s2d", False))
        feat_dim = backbone.picked_channels[-1]
        self.bev_embedding = nn.Parameter(
            torch.empty(self.bev_hw, self.bev_hw, dim))
        window = cfg.get("window", 8)
        num_cams = cfg.get("num_cams", 4)
        for k in range(self.layers):
            self.add_module(f"BEVWindowSelfAttention_{k}",
                            BEVWindowSelfAttention(dim, window, heads))
            self.add_module(f"PlanarLiftCrossAttention_{k}",
                            PlanarLiftCrossAttention(
                                dim, feat_dim, num_cams, self.z_points))
            for i in range(3):
                self.add_module(f"LayerNorm_{3 * k + i}", LayerNorm(dim))
            self.add_module(f"Dense_{2 * k}", Dense(2 * dim, dim))
            self.add_module(f"Dense_{2 * k + 1}", Dense(dim, 2 * dim))
        self.add_module(f"Dense_{2 * self.layers}", Dense(dim, out_dim))

    def reset_parameters(self, gen):
        normal_(self.bev_embedding, 0.02, gen)

    def forward(self, images, intrinsics, extrinsics, prev_bev=None):
        cfg = self.cfg
        bev_range = cfg.get("bev_range", 51.2)
        cdt = (DTYPES[cfg["compute_dtype"]] if "compute_dtype" in cfg
               else images.dtype)
        n, m, img_h, img_w, _ = images.shape
        feats = self.ResNetEncoder_0(
            images.reshape(n * m, img_h, img_w, 3).to(cdt))
        if isinstance(feats, list):
            feats = feats[-1]
        fh, fw = feats.shape[1:3]
        cam_feats = feats.reshape(n, m, fh, fw, -1)

        proj = lidar2img(intrinsics, extrinsics)
        z_values = torch.linspace(-2.0, 1.0, self.z_points,
                                  dtype=torch.float32, device=images.device)
        x = self.bev_embedding[None].expand(
            n, self.bev_hw, self.bev_hw, -1).to(cdt)
        prepared = planar_lift_prepare(cam_feats.to(cdt), proj, bev_range,
                                       z_values, (img_h, img_w), self.bev_hw)
        for k in range(self.layers):
            ln = [getattr(self, f"LayerNorm_{3 * k + i}") for i in range(3)]
            x = x + getattr(self, f"BEVWindowSelfAttention_{k}")(ln[0](x))
            x = x + getattr(self, f"PlanarLiftCrossAttention_{k}")(
                ln[1](x), prepared, cdt)
            hidden = gelu(getattr(self, f"Dense_{2 * k + 1}")(ln[2](x)))
            x = x + getattr(self, f"Dense_{2 * k}")(hidden)
        return getattr(self, f"Dense_{2 * self.layers}")(x).to(torch.float32)


# the class the reference's ``make_camera_encoder`` builds for this name
CAMERA_ENCODER = BEVFormerEncoder
