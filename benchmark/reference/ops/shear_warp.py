"""Separable 2-pass bilinear affine warp (port of
``hmvit_tpu/ops/shear_warp.py``): the plain twin of the pair-warp
kernel.  Each pass is a dense banded interpolation matrix contracted
with the map:

    tmp[n, y', x, c]  = sum_y Sy[n, x, y', y] src[n, y, x, c]
    out[n, y', x', c] = sum_x Sx[n, y', x', x] tmp[n, y', x, c]

with the predicated transpose that keeps pass 2 well conditioned under
near-90-degree rotations, and zero padding from the interpolation
matrices.  Contractions accumulate in float32; the pass-1 result is
rounded to the map's dtype before pass 2, as in the JAX package.
"""
from __future__ import annotations

import torch

from .warp import (
    _affine_to_homography,
    _inv_affine3,
    _normal_transform_pixel,
    centered_affine,
    discretize_transform,
)


def _pixel_affine(m, src_hw, dst_hw):
    """Pixel-space dst->src affine (N, 2, 3) of the ops.warp chain."""
    h, w = src_hw
    oh, ow = dst_hw
    f32 = torch.float32
    dev = m.device
    m33 = _affine_to_homography(m.to(f32))
    src_norm = _normal_transform_pixel(h, w, f32, dev)
    dst_norm = _normal_transform_pixel(oh, ow, f32, dev)
    chain = dst_norm[None] @ (m33 @ _inv_affine3(src_norm)[None])
    theta = _inv_affine3(chain)
    px = _inv_affine3(src_norm)[None] @ (theta @ dst_norm[None])
    return px[:, :2, :]


def _interp_matrix(coords, size: int, dtype):
    """coords (..., K) -> (..., K, size) linear interpolation weights,
    zero outside [0, size)."""
    x0 = torch.floor(coords)
    frac = (coords - x0).to(dtype)
    x0i = x0.to(torch.int64)
    cells = torch.arange(size, device=coords.device)
    zero = torch.zeros((), dtype=dtype, device=coords.device)
    w0 = torch.where(cells == x0i[..., None], (1.0 - frac)[..., None], zero)
    w1 = torch.where(cells == (x0i + 1)[..., None], frac[..., None], zero)
    return w0 + w1


def _affine_coefficients(a):
    """Post-swap pass coefficients of dst->src pixel affines a (N, 2, 3):
    (m00, m01, tx, v0, v1, ty_adj, swap), each (N,).  When the map is
    y-dominant the SOURCE is read transposed, which swaps the rows."""
    m00, m01, tx = a[:, 0, 0], a[:, 0, 1], a[:, 0, 2]
    m10, m11, ty = a[:, 1, 0], a[:, 1, 1], a[:, 1, 2]
    swap = torch.abs(m00) < torch.abs(m10)

    def pick(p, q):
        return torch.where(swap, p, q)

    m00, m01, tx, m10, m11, ty = (
        pick(m10, m00), pick(m11, m01), pick(ty, tx),
        pick(m00, m10), pick(m01, m11), pick(tx, ty),
    )
    det = m00 * m11 - m01 * m10
    safe_m00 = torch.where(torch.abs(m00) < 1e-6,
                           torch.full_like(m00, 1e-6), m00)
    v0 = m10 / safe_m00
    v1 = det / safe_m00
    ty_adj = ty - v0 * tx
    return m00, m01, tx, v0, v1, ty_adj, swap


def warp_affine_mxu(src, m, dsize):
    """Bilinear affine warp of square (N, H, W, C) maps by pixel-space
    affines m (N, 2, 3) via two dense contractions."""
    n, h, w, c = src.shape
    oh, ow = dsize
    if not h == w == oh == ow:
        raise ValueError(f"separable warp needs square maps of one size, "
                         f"got {(h, w)} -> {(oh, ow)}")
    dtype = src.dtype
    dev = src.device
    a = _pixel_affine(m, (h, w), dsize)
    m00, m01, tx, v0, v1, ty_adj, swap = _affine_coefficients(a)
    src_in = torch.where(swap[:, None, None, None], src.transpose(1, 2), src)

    f32 = torch.float32
    xs = torch.arange(ow, dtype=f32, device=dev)
    ys = torch.arange(oh, dtype=f32, device=dev)
    xu = torch.arange(w, dtype=f32, device=dev)
    # pass 1 (y-resample): y(x_u, y') = v1 y' + v0 x_u + ty_adj
    y_coords = (v1[:, None, None] * ys[None, :, None]
                + v0[:, None, None] * xu[None, None, :]
                + ty_adj[:, None, None])  # (N, H', W)
    sy = _interp_matrix(y_coords.transpose(1, 2), h, dtype)  # (N, W, H', H)
    tmp = torch.einsum("nxYy,nyxc->nYxc", sy.to(f32), src_in.to(f32))
    # pass 2 (x-resample): x_u(y', x') = m00 x' + m01 y' + tx
    x_coords = (m00[:, None, None] * xs[None, None, :]
                + m01[:, None, None] * ys[None, :, None]
                + tx[:, None, None])  # (N, H', W')
    sx = _interp_matrix(x_coords, w, dtype)  # (N, H', W', W)
    out = torch.einsum("nYXx,nYxc->nYXc", sx.to(f32),
                       tmp.to(dtype).to(f32))
    return out.to(dtype)


def warp_bev_mxu(features, transform, discrete_ratio: float,
                 downsample_rate: float):
    """Warp (..., H, W, C) BEV maps by (..., 4, 4) per-map transforms."""
    *batch, h, w, c = features.shape
    m = discretize_transform(transform, discrete_ratio, downsample_rate)
    t = centered_affine(m.reshape(-1, 2, 3).to(torch.float32), (h, w))
    out = warp_affine_mxu(features.reshape(-1, h, w, c), t, (h, w))
    return out.reshape(*batch, h, w, c)
