"""BEV affine geometry between agent frames (port of
``hmvit_tpu/ops/warp.py``): discretized transforms, the centred-pivot
affine, align_corners=True normalization, the warped ROI masks and the
gather (non-separable) bilinear warp ``warp_bev_nhwc``.

All 3x3 algebra runs in float32 with the same operation order as the
JAX package, so per-pixel source coordinates (and the rounded ROI masks
built from them) agree with it.
"""
from __future__ import annotations

import torch

from ..utils.constants import device_constant


def discretize_transform(matrix, discrete_ratio: float,
                         downsample_rate: float):
    """(..., 4, 4) frame transform -> (..., 2, 3) BEV-pixel affine."""
    m = matrix[..., :2, :]
    m = torch.cat([m[..., :2], m[..., 3:]], dim=-1)  # columns 0, 1, 3
    scale = discrete_ratio * downsample_rate
    # true division by a tensor, as XLA does (a scalar divisor would be
    # turned into a reciprocal multiply)
    t = m[..., 2:] / torch.full_like(m[..., 2:], scale)
    return torch.cat([m[..., :2], t], dim=-1)


def _affine_to_homography(m):
    """(..., 2, 3) -> (..., 3, 3) with last row [0, 0, 1]."""
    last = torch.zeros((*m.shape[:-2], 1, 3), dtype=m.dtype, device=m.device)
    last[..., 0, 2] = 1.0
    return torch.cat([m, last], dim=-2)


def _normal_transform_pixel(h: int, w: int, dtype, device):
    """Pixel -> [-1, 1] normalization matrix (align_corners=True)."""
    wd = 1.0 if w == 1 else w - 1.0
    hd = 1.0 if h == 1 else h - 1.0
    return device_constant(
        ((2.0 / wd, 0.0, -1.0), (0.0, 2.0 / hd, -1.0), (0.0, 0.0, 1.0)),
        dtype, device)


def _inv_affine3(m):
    """Closed-form inverse of (..., 3, 3) affine homographies."""
    a, b, tx = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    c, d, ty = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack(
        [torch.stack([ia, ib, itx], -1),
         torch.stack([ic, id_, ity], -1),
         torch.stack([zeros, zeros, ones], -1)], dim=-2)


def centered_affine(m, dsize):
    """Rotate around the image center, then translate: (N, 2, 3) ->
    (N, 2, 3)."""
    h, w = dsize
    n = m.shape[0]
    eye = torch.eye(3, dtype=m.dtype, device=m.device).expand(n, 3, 3)
    center = device_constant((w / 2.0, h / 2.0), m.dtype, m.device)
    shift = eye.clone()
    shift[:, :2, 2] = center
    shift_inv = eye.clone()
    shift_inv[:, :2, 2] = -center
    rot = eye.clone()
    rot[:, :2, :2] = m[:, :2, :2]
    out = (shift @ (rot @ shift_inv))[:, :2, :]
    return torch.cat([out[:, :, :2], out[:, :, 2:] + m[:, :, 2:]], dim=-1)


def _source_coords(m, src_hw, dsize):
    """Source pixel coordinates (px, py), each (N, H', W'), of every
    output pixel under affine_grid(align_corners=True) conventions."""
    h, w = src_hw
    out_h, out_w = dsize
    dev = m.device
    f32 = torch.float32
    m33 = _affine_to_homography(m.to(f32))
    src_norm = _normal_transform_pixel(h, w, f32, dev)
    dst_norm = _normal_transform_pixel(out_h, out_w, f32, dev)
    chain = dst_norm[None] @ (m33 @ _inv_affine3(src_norm)[None])
    theta = _inv_affine3(chain)[:, :2, :]
    xs = torch.linspace(-1.0, 1.0, out_w, dtype=f32, device=dev)
    ys = torch.linspace(-1.0, 1.0, out_h, dtype=f32, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")

    def row(i):
        t = theta[:, i]
        return (t[:, 0, None, None] * gx + t[:, 1, None, None] * gy
                + t[:, 2, None, None])

    px = (row(0) + 1.0) * (w - 1) / 2.0
    py = (row(1) + 1.0) * (h - 1) / 2.0
    return px, py


def warp_affine_nhwc(src, m, dsize, mode: str = "bilinear"):
    """Warp (N, H, W, C) maps by pixel-space affines m (N, 2, 3), as
    affine_grid(align_corners=True) + grid_sample with zero padding:
    ``m`` maps source pixels to destination pixels, sampling uses its
    inverse.  Plain gathers of whole channel rows."""
    n, h, w, c = src.shape
    out_h, out_w = dsize
    px, py = _source_coords(m, (h, w), dsize)
    flat = src.reshape(n, h * w, c)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
        vals = torch.gather(flat, 1, idx.reshape(n, -1, 1).expand(-1, -1, c))
        vals = vals.reshape(n, out_h, out_w, c)
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    if mode == "nearest":
        return gather(torch.round(py).long(), torch.round(px).long())
    x0 = torch.floor(px).long()
    y0 = torch.floor(py).long()
    wx = (px - x0.to(px.dtype)).to(src.dtype)[..., None]
    wy = (py - y0.to(py.dtype)).to(src.dtype)[..., None]
    top = gather(y0, x0) * (1 - wx) + gather(y0, x0 + 1) * wx
    bot = gather(y0 + 1, x0) * (1 - wx) + gather(y0 + 1, x0 + 1) * wx
    return top * (1 - wy) + bot * wy


def warp_bev_nhwc(features, transform, discrete_ratio: float,
                  downsample_rate: float, mode: str = "bilinear"):
    """Warp (..., H, W, C) BEV maps by (..., 4, 4) per-map transforms."""
    *batch, h, w, c = features.shape
    m = discretize_transform(transform, discrete_ratio, downsample_rate)
    t = centered_affine(m.reshape(-1, 2, 3).to(torch.float32), (h, w))
    out = warp_affine_nhwc(features.reshape(-1, h, w, c), t, (h, w), mode)
    return out.reshape(*batch, h, w, c)


def roi_mask(shape, transform, discrete_ratio: float,
             downsample_rate: float):
    """Valid-region mask after warping: (B, L, H, W) -> (B, L, 1, H, W)
    in {0, 1} — where the nearest-rounded source pixel lies in the map."""
    b, l, h, w = shape
    m = discretize_transform(transform, discrete_ratio, downsample_rate)
    t = centered_affine(m.reshape(-1, 2, 3), (h, w))
    px, py = _source_coords(t, (h, w), (h, w))
    xx = torch.round(px)
    yy = torch.round(py)
    valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    return valid.to(torch.float32).reshape(b, l, 1, h, w)


def roi_and_agent_mask(b, l, h, w, agent_mask, transform,
                       discrete_ratio: float, downsample_rate: float):
    """Combined warped-ROI and agent-validity mask -> (B, H, W, 1, L)."""
    roi = roi_mask((b, l, h, w), transform, discrete_ratio, downsample_rate)
    com = roi * agent_mask[:, :, None, None, None]
    return com.permute(0, 3, 4, 2, 1)
