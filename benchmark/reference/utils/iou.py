"""Rotated BEV IoU on the device (torch port of the ``xp`` functions of
``hmvit_tpu/utils/iou.py``): analytic convex-quad intersection —
candidate vertices (corners inside the other quad plus edge-edge
crossings), angle sort, shoelace.  And, in numpy on the host, the
axis-aligned IoU of anchor matching (:func:`aligned_iou`)."""
from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-8


def aligned_iou(boxes, query) -> np.ndarray:
    """Axis-aligned IoU matrix with the Pascal ``+1`` extent convention
    (the reference's Cython ``bbox_overlaps``, kept for bit-equal label
    generation): boxes (N, 4) [x1, y1, x2, y2], query (K, 4) -> (N, K)."""
    boxes = np.asarray(boxes)
    query = np.asarray(query)
    area_q = (query[:, 2] - query[:, 0] + 1) * (query[:, 3] - query[:, 1] + 1)
    area_b = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    iw = (np.minimum(boxes[:, None, 2], query[None, :, 2])
          - np.maximum(boxes[:, None, 0], query[None, :, 0]) + 1)
    ih = (np.minimum(boxes[:, None, 3], query[None, :, 3])
          - np.maximum(boxes[:, None, 1], query[None, :, 1]) + 1)
    inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
    union = area_b[:, None] + area_q[None, :] - inter
    return np.where(inter > 0, inter / union, np.zeros_like(inter))


def _ccw(quads):
    """Force counter-clockwise vertex order on (..., 4, 2) quads."""
    x, y = quads[..., 0], quads[..., 1]
    area2 = (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1)
    return torch.where(area2[..., None, None] < 0, quads.flip(-2), quads)


def _points_in_quad(points, quad):
    """points (..., P, 2), CCW quad (..., 4, 2) -> (..., P) bool."""
    a = quad[..., None, :, :]
    b = torch.roll(quad, -1, -2)[..., None, :, :]
    p = points[..., :, None, :]
    cross = ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
             - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))
    return (cross >= -1e-6).all(-1)


def _segment_intersections(qa, qb):
    """All 16 edge-edge intersection points (..., 16, 2) and validity."""
    a0 = qa[..., :, None, :]
    a1 = torch.roll(qa, -1, -2)[..., :, None, :]
    b0 = qb[..., None, :, :]
    b1 = torch.roll(qb, -1, -2)[..., None, :, :]
    da = a1 - a0
    db = b1 - b0
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    ok = torch.abs(denom) > _EPS
    denom = torch.where(ok, denom, torch.ones_like(denom))
    d0 = b0 - a0
    t = (d0[..., 0] * db[..., 1] - d0[..., 1] * db[..., 0]) / denom
    u = (d0[..., 0] * da[..., 1] - d0[..., 1] * da[..., 0]) / denom
    hit = ok & (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
    pts = a0 + t[..., None] * da
    batch = pts.shape[:-3]
    return pts.reshape(*batch, 16, 2), hit.reshape(*batch, 16)


def quad_intersection_area(qa, qb):
    """Intersection area of convex quads (..., 4, 2), any orientation."""
    qa, qb = _ccw(qa), _ccw(qb)
    in_b = _points_in_quad(qa, qb)
    in_a = _points_in_quad(qb, qa)
    cross_pts, cross_ok = _segment_intersections(qa, qb)
    pts = torch.cat([qa, qb, cross_pts], dim=-2)          # (..., 24, 2)
    valid = torch.cat([in_b, in_a, cross_ok], dim=-1)     # (..., 24)
    num_valid = valid.sum(-1)
    # invalid candidates take the first valid vertex's coordinates, so
    # after the angle sort they sit next to it and add zero area
    first_idx = torch.argmax(valid.to(torch.int8), dim=-1)
    first_pt = torch.take_along_dim(
        pts, first_idx[..., None, None].expand(*first_idx.shape, 1, 2),
        dim=-2)
    pts = torch.where(valid[..., None], pts, first_pt)
    center = (pts * valid[..., None]).sum(-2) / torch.clamp(
        num_valid[..., None], min=1)
    rel = pts - center[..., None, :]
    ang = torch.atan2(rel[..., 1], rel[..., 0])
    order = torch.argsort(ang, dim=-1)
    srel = torch.take_along_dim(rel, order[..., None].expand(*order.shape, 2),
                                dim=-2)
    nxt = torch.roll(srel, -1, -2)
    area = 0.5 * torch.abs(
        (srel[..., 0] * nxt[..., 1] - nxt[..., 0] * srel[..., 1]).sum(-1))
    return torch.where(num_valid >= 3, area, torch.zeros_like(area))


def quad_area(q):
    x, y = q[..., 0], q[..., 1]
    return 0.5 * torch.abs(
        (x * torch.roll(y, -1, -1) - torch.roll(x, -1, -1) * y).sum(-1))


def rotated_iou_matrix(corners_a, corners_b):
    """BEV IoU of rotated boxes from bottom-face corners (N, 4, 2) or
    (N, 8, 3) vs (M, 4, 2) -> (N, M)."""
    corners_a = corners_a[..., :4, :2]
    corners_b = corners_b[..., :4, :2]
    n, m = corners_a.shape[0], corners_b.shape[0]
    if n == 0 or m == 0:
        return torch.zeros((n, m), dtype=corners_a.dtype,
                           device=corners_a.device)
    qa = corners_a[:, None].expand(n, m, 4, 2)
    qb = corners_b[None, :].expand(n, m, 4, 2)
    inter = quad_intersection_area(qa, qb)
    union = quad_area(qa) + quad_area(qb) - inter
    return torch.where(union > _EPS, inter / torch.clamp(union, min=_EPS),
                       torch.zeros_like(inter))


# -- numpy (host) versions: the AP matching and the host NMS --------------
