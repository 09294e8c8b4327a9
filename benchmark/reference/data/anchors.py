"""The dense anchor grid and the training labels (numpy, host side) and
the anchor delta decode on tensors: the port's counterparts of
``generate_anchor_grid``, ``generate_labels`` and ``decode_deltas`` of
``hmvit_tpu/data/anchors.py``.  Box order is ``hwl``: (x, y, z, h, w, l,
yaw)."""
from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.boxes import boxes_to_corners_3d_np, corners_to_standup_np
from ..utils.iou import aligned_iou


def generate_anchor_grid(anchor_args: dict, order: str = "hwl") -> np.ndarray:
    """Build the dense BEV anchor grid -> (H', W', num_rot, 7).

    H' = H // feature_stride rows (y), W' = W // feature_stride cols (x):
    the row axis indexes y, matching the head's (H, W) feature map."""
    W, H = anchor_args["W"], anchor_args["H"]
    l, w, h = anchor_args["l"], anchor_args["w"], anchor_args["h"]
    rotations = [math.radians(r) for r in anchor_args["r"]]
    num = anchor_args.get("num", len(rotations))
    if num != len(rotations):
        raise ValueError(f"anchor num {num} != {len(rotations)} rotations")
    vw, vh = anchor_args["vw"], anchor_args["vh"]
    rng = anchor_args["cav_lidar_range"]
    stride = anchor_args.get("feature_stride", 2)

    x = np.linspace(rng[0] + vw, rng[3] - vw, W // stride)
    y = np.linspace(rng[1] + vh, rng[4] - vh, H // stride)
    cx, cy = np.meshgrid(x, y)  # (len(y), len(x))
    cx = np.tile(cx[..., None], num)
    cy = np.tile(cy[..., None], num)
    cz = np.full_like(cx, -1.0)
    ones = np.ones_like(cx)
    r_ = np.stack([np.full_like(cx[..., 0], r) for r in rotations], axis=-1)
    if order == "hwl":
        dims = [ones * h, ones * w, ones * l]
    elif order == "lhw":
        dims = [ones * l, ones * h, ones * w]
    else:
        raise ValueError(f"unsupported anchor order {order!r}")
    return np.stack([cx, cy, cz, *dims, r_], axis=-1)


def generate_labels(gt_box_center: np.ndarray, mask: np.ndarray,
                    anchors: np.ndarray, pos_threshold: float,
                    neg_threshold: float) -> dict:
    """Anchor classification / regression targets of one frame (the
    reference's VoxelPostprocessor contract): Pascal ``+1`` standup IoU
    between anchors and boxes, positives above ``pos_threshold`` plus
    each box's best anchor (if it overlaps at all), negatives below
    ``neg_threshold`` for every box, VoxelNet 7-dim delta targets.

    gt_box_center (max_num, 7) hwl boxes, mask (max_num,) 1 for real
    boxes, anchors (H, W, num, 7).  Returns ``pos_equal_one`` /
    ``neg_equal_one`` (H, W, num) and ``targets`` (H, W, 7 num), float64.
    """
    feat_shape = anchors.shape[:2]
    anchor_num = anchors.shape[2]
    anchors_flat = anchors.reshape(-1, 7)
    # anchor bev diagonal normalising the xy deltas (w = 4, l = 5 in hwl)
    anchors_d = np.sqrt(anchors_flat[:, 4] ** 2 + anchors_flat[:, 5] ** 2)
    pos_equal_one = np.zeros((*feat_shape, anchor_num))
    neg_equal_one = np.zeros((*feat_shape, anchor_num))
    targets = np.zeros((*feat_shape, anchor_num * 7))

    gt_valid = gt_box_center[mask == 1]
    n_gt = gt_valid.shape[0]
    anchors_standup = corners_to_standup_np(
        boxes_to_corners_3d_np(anchors_flat, "hwl")[:, :4])
    gt_standup = corners_to_standup_np(
        boxes_to_corners_3d_np(gt_valid, "hwl")[:, :4]) if n_gt \
        else np.zeros((0, 4))
    iou = aligned_iou(anchors_standup.astype(np.float32),
                      gt_standup.astype(np.float32))  # (anchors, n_gt)

    if n_gt:
        id_highest = np.argmax(iou.T, axis=1)
        id_highest_gt = np.arange(n_gt)
        keep = iou.T[id_highest_gt, id_highest] > 0
        id_highest, id_highest_gt = id_highest[keep], id_highest_gt[keep]
    else:
        id_highest = id_highest_gt = np.array([], dtype=np.int64)
    id_pos, id_pos_gt = np.where(iou > pos_threshold)
    id_neg = np.where(np.sum(iou < neg_threshold, axis=1) == iou.shape[1])[0]
    id_pos = np.concatenate([id_pos, id_highest])
    id_pos_gt = np.concatenate([id_pos_gt, id_highest_gt])
    id_pos, first = np.unique(id_pos, return_index=True)
    id_pos_gt = id_pos_gt[first]

    ix, iy, iz = np.unravel_index(id_pos, (*feat_shape, anchor_num))
    pos_equal_one[ix, iy, iz] = 1
    a = anchors_flat[id_pos]
    g = gt_valid[id_pos_gt] if n_gt else np.zeros((0, 7))
    d = anchors_d[id_pos]
    cols = np.asarray(iz) * 7
    targets[ix, iy, cols + 0] = (g[:, 0] - a[:, 0]) / d
    targets[ix, iy, cols + 1] = (g[:, 1] - a[:, 1]) / d
    targets[ix, iy, cols + 2] = (g[:, 2] - a[:, 2]) / a[:, 3]
    targets[ix, iy, cols + 3] = np.log(g[:, 3] / a[:, 3])
    targets[ix, iy, cols + 4] = np.log(g[:, 4] / a[:, 4])
    targets[ix, iy, cols + 5] = np.log(g[:, 5] / a[:, 5])
    targets[ix, iy, cols + 6] = g[:, 6] - a[:, 6]

    ix, iy, iz = np.unravel_index(id_neg, (*feat_shape, anchor_num))
    neg_equal_one[ix, iy, iz] = 1
    # an anchor forced positive as a box's best is never negative
    ix, iy, iz = np.unravel_index(id_highest, (*feat_shape, anchor_num))
    neg_equal_one[ix, iy, iz] = 0
    return {"pos_equal_one": pos_equal_one, "neg_equal_one": neg_equal_one,
            "targets": targets}


def decode_deltas(deltas, anchors):
    """(N, num*7, H, W) regression map + (H, W, num, 7) hwl anchors ->
    (N, H*W*num, 7) boxes (VoxelNet delta encoding)."""
    n = deltas.shape[0]
    d = deltas.permute(0, 2, 3, 1).reshape(n, -1, 7)
    a = anchors.reshape(-1, 7)[None]
    diag = torch.sqrt(a[..., 4] ** 2 + a[..., 5] ** 2)
    xy = d[..., 0:2] * diag[..., None] + a[..., 0:2]
    z = d[..., 2:3] * a[..., 3:4] + a[..., 2:3]
    hwl = torch.exp(d[..., 3:6]) * a[..., 3:6]
    yaw = d[..., 6:7] + a[..., 6:7]
    return torch.cat([xy, z, hwl, yaw], dim=-1)
