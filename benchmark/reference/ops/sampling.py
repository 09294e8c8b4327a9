"""Bilinear feature sampling at arbitrary continuous coordinates (port of
``hmvit_tpu/ops/sampling.py``).

Deformable attention's irregular reads: a gather of the 4 neighbours of
each sample point, then the lerp, vectorised over every leading axis.
Plain PyTorch, as in the JAX package, where this is XLA gathers and no
Pallas kernel.  Nothing here reads back to the host, so a CUDA graph can
capture it.
"""
from __future__ import annotations

import torch


def bilinear_sample(feats, coords):
    """Sample (B, H, W, C) features at continuous pixel coordinates.

    coords: (B, Q, 2) as (x, y) in pixel units, pixel i's centre at i;
    a tap outside the map reads 0.  Returns (B, Q, C)."""
    b, h, w, c = feats.shape
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1, y1 = x0 + 1, y0 + 1
    wx = (x - x0).to(feats.dtype)[..., None]
    wy = (y - y0).to(feats.dtype)[..., None]
    flat = feats.reshape(b, h * w, c)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (torch.clamp(yy, 0, h - 1) * w
               + torch.clamp(xx, 0, w - 1)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(*idx.shape, c))
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """Multi-scale deformable attention, mmcv's calling contract.

    value: (B, K, H, D) with K = sum(h * w) over the levels; each head
    reads only its own D-channel slice.  spatial_shapes: (h, w) per level
    (static).  sampling_locations: (B, Q, H, L, P, 2) as (x, y) in
    [0, 1], ``grid_sample(align_corners=False)``'s convention (0 and 1
    are the image's edges, pixel centres at (i + 0.5) / size).
    attention_weights: (B, Q, H, L, P), normalised over (L, P) by the
    caller.  Returns (B, Q, H * D)."""
    b, _, h, d = value.shape
    q, _, num_l, p = sampling_locations.shape[1:5]
    outs = []
    start = 0
    for lvl in range(num_l):
        hh, ww = (int(s) for s in spatial_shapes[lvl])
        v = value[:, start:start + hh * ww]
        start += hh * ww
        v = v.reshape(b, hh, ww, h, d).permute(0, 3, 1, 2, 4)
        v = v.reshape(b * h, hh, ww, d)
        loc = sampling_locations[:, :, :, lvl]  # (B, Q, H, P, 2)
        # pixel units: x * w - 0.5, y * h - 0.5
        pix = torch.stack([loc[..., 0] * ww, loc[..., 1] * hh], -1) - 0.5
        pix = pix.permute(0, 2, 1, 3, 4).reshape(b * h, q * p, 2)
        outs.append(bilinear_sample(v, pix).reshape(b, h, q, p, d))
    stacked = torch.stack(outs, 3)  # (B, H, Q, L, P, D)
    w = attention_weights.permute(0, 2, 1, 3, 4)  # (B, H, Q, L, P)
    out = torch.einsum("bhqlp,bhqlpd->bhqd", w, stacked)
    return out.permute(0, 2, 1, 3).reshape(b, q, h * d)
