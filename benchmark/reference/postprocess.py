"""Detection post-processing (port of ``hmvit_tpu/postprocess.py``): the
single-frame decode on the device (:func:`decode_detections_device`:
sigmoid score threshold, anchor delta decode, top-k, corners, sanity
filters, rotated NMS and the GT-range clip, all fixed-shape)."""
from __future__ import annotations

import torch

from . import GT_RANGE
from .data.anchors import decode_deltas
from .utils.boxes import (
    boxes_to_corners_3d,
    mask_corners_in_range,
    project_corners,
    sane_size_mask,
    sane_z_mask,
)
from .utils.nms import nms_rotated_device


def decode_detections_device(psm, rm, anchors, transform,
                             score_threshold: float = 0.27,
                             nms_threshold: float = 0.15,
                             max_boxes: int = 512):
    """psm (1, A, H, W) logits, rm (1, 7A, H, W), anchors (H, W, A, 7),
    transform (4, 4) to the ego frame.  Computes in float32.  Returns
    fixed-shape (corners (K, 8, 3), scores (K,), valid (K,) bool)."""
    f32 = torch.float32
    prob = torch.sigmoid(psm.to(f32).permute(0, 2, 3, 1).reshape(-1))
    boxes = decode_deltas(rm.to(f32), anchors.to(f32))[0]
    score = torch.where(prob > score_threshold, prob, torch.zeros_like(prob))
    k = min(max_boxes, score.shape[0])
    top_score, top_idx = torch.topk(score, k)
    corners = project_corners(boxes_to_corners_3d(boxes[top_idx], "hwl"),
                              transform)
    valid = (top_score > 0) & sane_size_mask(corners) & sane_z_mask(corners)
    masked = torch.where(valid, top_score, torch.zeros_like(top_score))
    keep, _ = nms_rotated_device(corners[:, :4, :2], masked, nms_threshold)
    valid = valid & keep & mask_corners_in_range(corners, GT_RANGE)
    return corners, masked, valid
