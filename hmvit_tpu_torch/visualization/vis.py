"""BEV rendering in numpy (port of ``hmvit_tpu/visualization/vis.py``).

The JAX module draws with matplotlib; the port rasterises into a uint8
image and writes it with :func:`hmvit_tpu_torch.data.codecs.write_png`,
so it needs no plotting library.  The picture is the JAX one: a black
background, the points white, the ground-truth boxes' bottom rings lime,
the predicted boxes' red (drawn last), over the ``pc_range`` window with
x to the right and y up, at equal scale on both axes.  A point or ring
corner at (x, y) lies in pixel ``(row, col) = bev_pixel(x, y)``.
"""
from __future__ import annotations

import os

import numpy as np

from ..data.codecs import write_png

BEV_PIXELS = 1200  # the long side of the BEV image
SEG_PIXELS = 512  # the least long side of a segmentation image
WHITE = (255, 255, 255)
LIME = (0, 255, 0)
RED = (255, 0, 0)
# viridis at 0, 1/4, 1/2, 3/4 and 1, interpolated linearly between
_VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                     [94, 201, 98], [253, 231, 37]], np.float64)


def bev_shape(pc_range) -> tuple:
    """(H, W) of the BEV image of ``pc_range``: BEV_PIXELS on the longer
    axis, the other in proportion."""
    xspan = float(pc_range[3] - pc_range[0])
    yspan = float(pc_range[4] - pc_range[1])
    scale = BEV_PIXELS / max(xspan, yspan)
    return (max(int(round(yspan * scale)), 1),
            max(int(round(xspan * scale)), 1))


def bev_pixel(xy, pc_range, shape) -> tuple:
    """(rows, cols) int64 of the points ``xy`` (..., >=2) in an image of
    ``shape`` over ``pc_range``; a point outside the window falls outside
    the image."""
    xy = np.asarray(xy, np.float64)
    h, w = shape
    x0, y0, x1, y1 = pc_range[0], pc_range[1], pc_range[3], pc_range[4]
    cols = np.floor((xy[..., 0] - x0) / (x1 - x0) * w)
    rows = np.floor((y1 - xy[..., 1]) / (y1 - y0) * h)
    return rows.astype(np.int64), cols.astype(np.int64)


def _set(img, rows, cols, color):
    h, w = img.shape[:2]
    keep = (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)
    img[rows[keep], cols[keep]] = color


def _clip(r0, c0, r1, c1, h, w):
    """Liang-Barsky: the part (t0, t1) of the segment from (r0, c0) to
    (r1, c1) that lies in rows [-1, h] and cols [-1, w], or ``None``."""
    dr, dc = r1 - r0, c1 - c0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dr, r0 + 1), (dr, h - r0), (-dc, c0 + 1), (dc, w - c0)):
        if p == 0:
            if q < 0:
                return None
        elif p < 0:
            t0 = max(t0, q / p)
        else:
            t1 = min(t1, q / p)
    return None if t0 > t1 else (t0, t1)


def _segment(img, r0, c0, r1, c1, color):
    """A one-pixel line from pixel (r0, c0) to (r1, c1), both included,
    drawn only where it crosses the image (clipped along its own
    direction, so a far corner does not turn it)."""
    part = _clip(r0, c0, r1, c1, *img.shape[:2])
    if part is None:
        return
    dr, dc = r1 - r0, c1 - c0
    ra, ca = r0 + part[0] * dr, c0 + part[0] * dc
    rb, cb = r0 + part[1] * dr, c0 + part[1] * dc
    n = int(np.ceil(max(abs(rb - ra), abs(cb - ca)))) + 1
    t = np.linspace(0.0, 1.0, n)
    _set(img, np.rint(ra + t * (rb - ra)).astype(np.int64),
         np.rint(ca + t * (cb - ca)).astype(np.int64), color)


def _rings(img, corners, pc_range, color):
    if corners is None:
        return
    rings = np.asarray(corners, np.float64)
    if not len(rings):
        return
    rows, cols = bev_pixel(rings[:, :4, :2], pc_range, img.shape[:2])
    for r, c in zip(rows, cols):
        for a in range(4):
            b = (a + 1) % 4
            _segment(img, r[a], c[a], r[b], c[b], color)


def render_bev(points, pred_corners, gt_corners, pc_range) -> np.ndarray:
    """One BEV frame as an (H, W, 3) uint8 RGB image.

    points: (N, >=2) or None; pred / gt corners: (K, 8, 3) or (K, 4, 2)
    or None; pc_range: [x0, y0, z0, x1, y1, z1]."""
    shape = bev_shape(pc_range)
    img = np.zeros((*shape, 3), np.uint8)
    if points is not None and len(points):
        rows, cols = bev_pixel(np.asarray(points)[:, :2], pc_range, shape)
        _set(img, rows, cols, WHITE)
    _rings(img, gt_corners, pc_range, LIME)
    _rings(img, pred_corners, pc_range, RED)
    return img


def visualize_bev(points, pred_corners, gt_corners, pc_range,
                  save_path: str | None = None) -> np.ndarray:
    """Render one frame (:func:`render_bev`) and write it as a PNG to
    ``save_path`` when given; returns the image."""
    img = render_bev(points, pred_corners, gt_corners, pc_range)
    if save_path:
        write_png(save_path, img)
    return img


def visualize_sequence(frames, pc_range, out_dir: str):
    """frames: iterable of (points, pred_corners, gt_corners); writes
    ``out_dir/%05d.png``."""
    os.makedirs(out_dir, exist_ok=True)
    for i, (pts, pred, gt) in enumerate(frames):
        visualize_bev(pts, pred, gt, pc_range,
                      save_path=os.path.join(out_dir, f"{i:05d}.png"))


def seg_colours(seg) -> np.ndarray:
    """(H, W) class map -> (H, W, 3) uint8 through viridis, the lowest
    class dark violet and the highest yellow (matplotlib's ``imshow``
    colour scale of the JAX module)."""
    seg = np.asarray(seg, np.float64)
    lo, hi = (seg.min(), seg.max()) if seg.size else (0.0, 0.0)
    t = (seg - lo) / (hi - lo) if hi > lo else np.zeros_like(seg)
    pos = t * (len(_VIRIDIS) - 1)
    i0 = np.minimum(np.floor(pos).astype(np.int64), len(_VIRIDIS) - 2)
    frac = (pos - i0)[..., None]
    rgb = _VIRIDIS[i0] * (1.0 - frac) + _VIRIDIS[i0 + 1] * frac
    return np.rint(rgb).astype(np.uint8)


def visualize_seg(seg_logits, save_path: str | None = None) -> np.ndarray:
    """Render a (H, W) class map or (C, H, W) logits (argmax over C),
    each cell repeated to at least SEG_PIXELS on the longer side, and
    write it as a PNG to ``save_path`` when given; returns the image."""
    seg = np.asarray(seg_logits)
    if seg.ndim == 3:
        seg = seg.argmax(0)
    img = seg_colours(seg)
    k = max(1, -(-SEG_PIXELS // max(img.shape[:2])))
    img = np.repeat(np.repeat(img, k, axis=0), k, axis=1)
    if save_path:
        write_png(save_path, img)
    return img
