"""Box geometry on tensors (torch versions of the numpy ``xp`` functions
of ``hmvit_tpu/utils/boxes.py``), and the numpy functions the synthetic
scenes, the anchor labels, the dataset and the evaluation need.

Boxes are ``(x, y, z, dims..., yaw)`` with dims ordered ``hwl`` or
``lwh``; corners follow the JAX package's numbering: 0-3 the bottom face
walked as a closed ring, 4-7 the top face.  Rotations and transforms are
written elementwise, as in the JAX package, so float32 geometry matches
it operation for operation.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import device_constant

# (8, 3) half-extent multipliers of the corner numbering above
CORNER_TEMPLATE = np.array(
    [
        [1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
        [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
    ],
    dtype=np.float64,
) / 2.0
_CORNER_TEMPLATE = tuple(map(tuple, CORNER_TEMPLATE.tolist()))


def boxes_to_corners_3d_np(boxes, order: str = "lwh") -> np.ndarray:
    """(N, 7) center boxes -> (N, 8, 3) corners, float64 numpy."""
    boxes = np.asarray(boxes, dtype=np.float64)
    if order == "lwh":
        dims = boxes[:, 3:6]
    elif order == "hwl":
        dims = boxes[:, [5, 4, 3]]
    else:
        raise ValueError(f"unknown box order {order!r}")
    corners = dims[:, None, :] * CORNER_TEMPLATE[None, :, :]
    c = np.cos(boxes[:, 6])[:, None]
    s = np.sin(boxes[:, 6])[:, None]
    x, y, z = corners[..., 0], corners[..., 1], corners[..., 2]
    corners = np.stack([x * c - y * s, x * s + y * c, z], axis=-1)
    return corners + boxes[:, None, 0:3]


def corners_to_boxes(corners, order: str = "lwh") -> np.ndarray:
    """(N, 8, 3) corners -> (N, 7) center boxes, float64 numpy.

    Averages the redundant edge measurements, so it is the exact inverse
    of :func:`boxes_to_corners_3d_np` for well-formed boxes and a
    least-squares estimate for noisy ones."""
    corners = np.asarray(corners, dtype=np.float64)
    assert corners.ndim == 3

    xyz = np.mean(corners[:, [0, 3, 5, 6], :], axis=1)
    h = np.abs(np.mean(corners[:, 4:, 2] - corners[:, :4, 2], axis=1))

    def edge(a, b):
        return np.linalg.norm(corners[:, a, :2] - corners[:, b, :2], axis=1)

    l = (edge(0, 3) + edge(2, 1) + edge(4, 7) + edge(5, 6)) / 4.0
    w = (edge(0, 1) + edge(2, 3) + edge(4, 5) + edge(6, 7)) / 4.0

    def yaw(a, b):
        d = corners[:, a, :2] - corners[:, b, :2]
        return np.arctan2(d[:, 1], d[:, 0])

    theta = (yaw(1, 2) + yaw(0, 3) + yaw(5, 6) + yaw(4, 7)) / 4.0

    if order == "lwh":
        dims = np.stack([l, w, h], axis=1)
    elif order == "hwl":
        dims = np.stack([h, w, l], axis=1)
    else:
        raise ValueError(f"unknown box order {order!r}")
    return np.concatenate([xyz, dims, theta[:, None]], axis=1)


def corners_to_standup_np(corners) -> np.ndarray:
    """(N, K, 2+) corners -> (N, 4) axis-aligned [x1, y1, x2, y2]."""
    return np.stack([corners[..., 0].min(axis=1), corners[..., 1].min(axis=1),
                     corners[..., 0].max(axis=1), corners[..., 1].max(axis=1)],
                    axis=1)


def mask_boxes_outside_range_np(boxes, limit_range, order,
                                min_num_corners: int = 8) -> np.ndarray:
    """Keep boxes with >= min_num_corners corners inside the xy range."""
    corners = boxes_to_corners_3d_np(boxes, order)
    lo = np.asarray(limit_range[:2])[None, None]
    hi = np.asarray(limit_range[3:5])[None, None]
    inside = np.all((corners[:, :, :2] >= lo) & (corners[:, :, :2] <= hi),
                    axis=-1)
    return inside.sum(axis=1) >= min_num_corners


def boxes_to_corners_3d(boxes, order: str = "lwh"):
    """(N, 7) center boxes -> (N, 8, 3) corners (the JAX function's
    default order, ``lwh``)."""
    if order == "hwl":
        dims = boxes[:, 3:6].flip(-1)  # columns 5, 4, 3
    elif order == "lwh":
        dims = boxes[:, 3:6]
    else:
        raise ValueError(f"unknown box order {order!r}")
    tmpl = device_constant(_CORNER_TEMPLATE, boxes.dtype, boxes.device)
    corners = dims[:, None, :] * tmpl[None]
    c = torch.cos(boxes[:, 6])[:, None]
    s = torch.sin(boxes[:, 6])[:, None]
    x, y, z = corners[..., 0], corners[..., 1], corners[..., 2]
    corners = torch.stack([x * c - y * s, x * s + y * c, z], dim=-1)
    return corners + boxes[:, None, 0:3]


def project_corners(corners, transform):
    """Transform (N, 8, 3) corners by a 4x4 matrix (elementwise)."""
    n = corners.shape[0]
    pts = corners.reshape(-1, 3)
    pts = torch.cat([pts, torch.ones_like(pts[:, :1])], dim=1)
    t = transform.to(pts.dtype)
    return (pts[:, None, :] * t[None, :3, :]).sum(-1).reshape(n, 8, 3)


def sane_size_mask(corners, max_len: float = 6.0):
    x_len = corners[:, :, 0].amax(1) - corners[:, :, 0].amin(1)
    y_len = corners[:, :, 1].amax(1) - corners[:, :, 1].amin(1)
    return (x_len <= max_len) & (y_len <= max_len) & (y_len > 0)


def sane_z_mask(corners, z_min: float = -3.0, z_max: float = 1.0):
    return ((corners[:, :, 2].amin(1) >= z_min)
            & (corners[:, :, 2].amax(1) <= z_max))


def mask_corners_in_range(corners, limit_range):
    """True where every corner's xy lies inside the range."""
    lo = device_constant(tuple(limit_range[:2]), corners.dtype,
                         corners.device)
    hi = device_constant(tuple(limit_range[3:5]), corners.dtype,
                         corners.device)
    ok = ((corners[:, :, :2] >= lo).all(-1)
          & (corners[:, :, :2] <= hi).all(-1))
    return ok.all(-1)


def points_in_rotated_box_mask(points: np.ndarray,
                               box_corners: np.ndarray) -> np.ndarray:
    """Boolean mask of 2D points (N, >= 2) inside one rotated rectangle
    given by its corners (4, 2), numbered as above."""
    p1, p2, p4 = box_corners[0], box_corners[1], box_corners[3]
    e12, e14 = p2 - p1, p4 - p1
    rel = points[:, :2] - p1[None, :]
    t = rel @ e12 / np.dot(e12, e12)
    u = rel @ e14 / np.dot(e14, e14)
    return (t >= 0) & (t <= 1) & (u >= 0) & (u <= 1)
