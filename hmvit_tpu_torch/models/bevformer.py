"""BEVFormer-style camera -> BEV encoder (port of
``hmvit_tpu/models/bevformer.py``), with two lifts.

Planar (the default): per layer, windowed BEV self-attention (the plain
window attention kernel), then the planar-lift cross attention — for
each (camera, height plane) the BEV->image map is a homography, so every
query's projected reference point is sampled by one dense separable
projective warp, and per-query weights over the (camera, plane)
hypotheses reduce them — then a GELU feed-forward.

Deformable (``lift: deformable``): per layer, the reference's temporal
deformable self-attention over the BEV plane, then its spatial cross
attention, which lifts each query to pillar points, projects them into
every camera and samples learned offsets around each projection
(:func:`hmvit_tpu_torch.ops.sampling.bilinear_sample`, gathers: the JAX
package's stand-in for the reference's CUDA ``ms_deform_attn``, no
Pallas kernel), then a GELU feed-forward.  Each head samples its own
channel slice only (the JAX package gathers every head's channels and
keeps the diagonal: the same values).

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
from ..ops.sampling import bilinear_sample
from .cvt import (
    _matvec,
    backbone_name,
    make_image_backbone,
    single_output_channels,
)
from .fusion.v2xvit import WindowSelfAttention
from .layers import NaiveDecoder
from .resnet import FPN
from ..utils.constants import device_constant

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


def _sample_heads(value, coords, heads: int):
    """Each head's channel slice of ``value`` (B, H, W, heads * D) sampled
    at that head's points: coords (B, heads, S, 2) pixel (x, y) ->
    (B, heads, S, D)."""
    b, hh, ww, c = value.shape
    d = c // heads
    v = value.reshape(b, hh, ww, heads, d).permute(0, 3, 1, 2, 4)
    out = bilinear_sample(v.reshape(b * heads, hh, ww, d),
                          coords.reshape(b * heads, -1, 2))
    return out.reshape(b, heads, -1, d)


class DeformableSelfAttention(nn.Module):
    """BEV-plane temporal deformable self-attention with the reference's
    two-slot BEV queue: values are the stacked [previous-or-current,
    current] maps, sampling offsets and per-point weights (softmax over a
    slot's points) are conditioned on concat([previous, query]), and the
    two slots' outputs are averaged.  Without a previous map the current
    one fills both slots."""

    def __init__(self, dim: int, heads: int = 4, points: int = 4,
                 queue: int = 2):
        super().__init__()
        self.dim, self.heads, self.points, self.queue = (dim, heads, points,
                                                         queue)
        hp = heads * points
        self.offsets = Dense(2 * dim, queue * hp * 2)
        self.weights = Dense(2 * dim, queue * hp)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, query, bev_2d, ref_xy, prev_2d=None):
        """query (N, Q, C), bev_2d (N, Hb, Wb, C), ref_xy (Q, 2) pixels,
        prev_2d (N, Hb, Wb, C) or None -> (N, Q, C)."""
        n, q, _ = query.shape
        hb, wb = bev_2d.shape[1:3]
        s, h, p = self.queue, self.heads, self.points
        if prev_2d is None:
            prev_2d = bev_2d
        cond = torch.cat([prev_2d.reshape(n, q, -1).to(query.dtype), query],
                         dim=-1)
        offsets = self.offsets(cond).reshape(n, q, s, h, p, 2)
        weights = torch.softmax(self.weights(cond).reshape(n, q, s, h, p),
                                dim=-1)
        value = self.value(torch.stack([prev_2d, bev_2d], 0))
        # (queue, N, heads, Q, P, 2): slot 0 the history, slot 1 current
        coords = ref_xy[None, None, :, None, None, :] + offsets.permute(
            2, 0, 1, 3, 4, 5)
        coords = coords.permute(0, 1, 3, 2, 4, 5)
        sampled = _sample_heads(
            value.reshape(s * n, hb, wb, self.dim),
            coords.reshape(s * n, h, q * p, 2), h)
        sampled = sampled.reshape(s, n, h, q, p, -1)
        out = torch.einsum("nqshp,snhqpd->nqhd", weights.float(),
                           sampled.float())
        out = out / s  # the mean over the BEV queue
        return self.out(out.reshape(n, q, self.dim))


class SpatialCrossAttention(nn.Module):
    """Lift BEV queries to pillar points, project them into every camera
    and sample learned offsets around each projection; the weights of
    the points a camera does not see are 0, and the sum is divided by
    the number of cameras that see a query (at least 1)."""

    def __init__(self, dim: int, heads: int = 4, points: int = 2,
                 z_points: int = 4):
        super().__init__()
        self.dim, self.heads, self.points, self.z_points = (dim, heads,
                                                            points, z_points)
        hzp = heads * z_points * points
        self.offsets = Dense(dim, hzp * 2)
        self.weights = Dense(dim, hzp)
        self.value = Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, query, cam_feats, proj, bev_xy_metric, z_values,
                img_hw):
        """query (N, Q, C), cam_feats (N, M, Hf, Wf, C), proj (N, M, 3, 4),
        bev_xy_metric (Q, 2), z_values (Z,) -> (N, Q, C)."""
        n, q, _ = query.shape
        m, fh, fw = cam_feats.shape[1:4]
        h, z, p = self.heads, self.z_points, self.points
        img_h, img_w = img_hw
        f32 = torch.float32
        # the pillar points (Q, Z, 4) homogeneous, projected exactly in
        # float32 (the JAX einsum runs at Precision.HIGHEST)
        hom = torch.cat([bev_xy_metric[:, None, :].expand(q, z, 2),
                         z_values[None, :, None].expand(q, z, 1),
                         torch.ones((q, z, 1), dtype=f32,
                                    device=query.device)], dim=-1)
        uvw = _matvec(proj.to(f32)[:, :, None, None], hom)  # (N, M, Q, Z, 3)
        depth = uvw[..., 2]
        uv = uvw[..., :2] / torch.clamp(depth, min=0.1)[..., None]
        inside = ((depth > 0.1) & (uv[..., 0] >= 0) & (uv[..., 0] < img_w)
                  & (uv[..., 1] >= 0) & (uv[..., 1] < img_h))
        uv_f = torch.stack([uv[..., 0] * (fw / img_w),
                            uv[..., 1] * (fh / img_h)], dim=-1)

        offsets = self.offsets(query).reshape(n, 1, q, h, z, p, 2)
        weights = torch.softmax(self.weights(query).reshape(n, q, h, z * p),
                                dim=-1).reshape(n, 1, q, h, z, p)
        value = self.value(cam_feats)
        coords = uv_f[:, :, :, None, :, None, :] + offsets  # (N,M,Q,H,Z,P,2)
        sampled = _sample_heads(
            value.reshape(n * m, fh, fw, self.dim),
            coords.permute(0, 1, 3, 2, 4, 5, 6).reshape(n * m, h, -1, 2), h)
        sampled = sampled.reshape(n, m, h, q, z, p, -1)
        w = weights * inside[:, :, :, None, :, None]
        out = torch.einsum("nmqhzp,nmhqzpd->nqhd", w.float(),
                           sampled.float())
        count = torch.clamp(inside.any(-1).sum(1).to(out.dtype), min=1.0)
        out = out / count[:, :, None, None]
        return self.out(out.reshape(n, q, self.dim))


class BEVFormerLayer(nn.Module):
    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.DeformableSelfAttention_0 = DeformableSelfAttention(dim, heads)
        self.SpatialCrossAttention_0 = SpatialCrossAttention(dim, heads)
        for i in range(3):
            self.add_module(f"LayerNorm_{i}", LayerNorm(dim))
        self.Dense_0 = Dense(2 * dim, dim)
        self.Dense_1 = Dense(dim, 2 * dim)

    def forward(self, bev_q, cam_feats, proj, grid_xy_pix, grid_xy_metric,
                z_values, img_hw, bev_hw, prev_2d=None):
        n, _, c = bev_q.shape
        bev_2d = bev_q.reshape(n, bev_hw, bev_hw, c)
        x = bev_q + self.DeformableSelfAttention_0(
            self.LayerNorm_0(bev_q), bev_2d, grid_xy_pix, prev_2d=prev_2d)
        x = x + self.SpatialCrossAttention_0(
            self.LayerNorm_1(x), cam_feats, proj, grid_xy_metric, z_values,
            img_hw)
        return x + self.Dense_0(gelu(self.Dense_1(self.LayerNorm_2(x))))


class BEVFormerEncoder(nn.Module):
    """(N, M, H, W, 3) images + calibration -> (N, out, out, out_dim) BEV
    by the planar lift (``lift: planar``, the default) or the deformable
    one (``lift: deformable``); ``decoder_layers`` upsampling blocks
    follow (default 0 for the planar lift, 2 for the deformable).  The
    planar lift's compute dtype follows the images unless the config
    names one.  With ``return_history`` the deformable lift also returns
    its last layer's BEV at the internal width, which a next frame takes
    as ``prev_bev``."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        self.cfg = cfg
        self.lift = cfg.get("lift", "planar")
        if self.lift not in ("planar", "deformable"):
            raise ValueError(f"unknown BEVFormer lift {self.lift!r}")
        planar = self.lift == "planar"
        dim = cfg.get("dim", 256 if planar else 128)
        self.dim = dim
        self.bev_hw = cfg.get("bev_size", 128 if planar else 32)
        out_dim = cfg.get("out_dim", 256)
        self.layers = cfg.get("num_layers", 3)
        heads = cfg.get("heads", 8 if planar else 4)
        self.z_points = cfg.get("num_points_in_pillar", 4)
        backbone = make_image_backbone(cfg)
        self.backbone_name = backbone_name(backbone)
        self.add_module(self.backbone_name, backbone)
        picked = backbone.picked_channels
        if planar:
            if cfg.get("fpn"):
                self.fpn = FPN(picked, cfg.get("fpn_channels", 256))
                feat_dim = cfg.get("fpn_channels", 256)
            else:
                feat_dim = picked[-1]
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
        else:
            self.Dense_0 = Dense(
                single_output_channels(backbone, "deformable BEVFormer"),
                dim)
            self.bev_embedding = nn.Parameter(
                torch.empty(self.bev_hw * self.bev_hw, dim))
            self.blocks = []
            for k in range(self.layers):
                blk = BEVFormerLayer(dim, heads)
                self.add_module(f"BEVFormerLayer_{k}", blk)
                self.blocks.append(blk)
            self.Dense_1 = Dense(dim, out_dim)
        up = cfg.get("decoder_layers", 0 if planar else 2)
        if up:
            self.NaiveDecoder_0 = NaiveDecoder(out_dim, up, [out_dim] * up,
                                               use_upsample=True)

    def reset_parameters(self, gen):
        normal_(self.bev_embedding, 0.02, gen)

    def _decode(self, bev):
        decoder = getattr(self, "NaiveDecoder_0", None)
        return bev if decoder is None else decoder(bev)

    def forward(self, images, intrinsics, extrinsics, prev_bev=None):
        if self.lift == "planar":
            return self._planar(images, intrinsics, extrinsics)
        return self._deformable(images, intrinsics, extrinsics, prev_bev)

    def _planar(self, images, intrinsics, extrinsics):
        cfg = self.cfg
        bev_range = cfg.get("bev_range", 51.2)
        cdt = (DTYPES[cfg["compute_dtype"]] if "compute_dtype" in cfg
               else images.dtype)
        n, m, img_h, img_w, _ = images.shape
        feats = getattr(self, self.backbone_name)(
            images.reshape(n * m, img_h, img_w, 3).to(cdt))
        if isinstance(feats, list):
            feats = self.fpn(feats)[0] if cfg.get("fpn") else feats[-1]
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
        bev = getattr(self, f"Dense_{2 * self.layers}")(x).to(torch.float32)
        return self._decode(bev)

    def _deformable(self, images, intrinsics, extrinsics, prev_bev=None):
        cfg = self.cfg
        bev_range = cfg.get("bev_range", 51.2)
        n, m, img_h, img_w, _ = images.shape
        dim, bev_hw = self.dim, self.bev_hw
        feats = self.Dense_0(getattr(self, self.backbone_name)(
            images.reshape(n * m, img_h, img_w, 3)))
        fh, fw = feats.shape[1:3]
        cam_feats = feats.reshape(n, m, fh, fw, dim)
        proj = lidar2img(intrinsics, extrinsics)

        q = bev_hw * bev_hw
        bev_q = self.bev_embedding[None].expand(n, q, dim)
        dev = images.device
        ii, jj = torch.meshgrid(torch.arange(bev_hw, device=dev),
                                torch.arange(bev_hw, device=dev),
                                indexing="ij")
        grid_xy_pix = torch.stack([jj, ii], -1).reshape(q, 2).to(
            torch.float32)
        # metric xy of each query (x along j, y along i)
        step = 2 * bev_range / bev_hw
        grid_xy_metric = (grid_xy_pix + 0.5) * step - bev_range
        z_values = torch.linspace(-2.0, 1.0, self.z_points,
                                  dtype=torch.float32, device=dev)
        # every layer's temporal attention takes the same previous BEV
        if prev_bev is not None and prev_bev.ndim == 3:
            prev_bev = prev_bev.reshape(n, bev_hw, bev_hw, dim)
        for blk in self.blocks:
            bev_q = blk(bev_q, cam_feats, proj, grid_xy_pix, grid_xy_metric,
                        z_values, (img_h, img_w), bev_hw, prev_2d=prev_bev)
        history = bev_q.reshape(n, bev_hw, bev_hw, dim)
        bev = self._decode(self.Dense_1(history))
        if cfg.get("return_history"):
            return bev, history
        return bev
