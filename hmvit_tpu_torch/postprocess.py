"""Detection post-processing (port of ``hmvit_tpu/postprocess.py``): the
single-frame decode on the device (:func:`decode_detections_device`:
sigmoid score threshold, anchor delta decode, top-k, corners, sanity
filters, rotated NMS and the GT-range clip, all fixed-shape), and
:class:`AnchorPostprocessor`, which makes the training labels and merges
the decoded boxes of several agents by a joint host NMS for the
evaluation; :func:`build_postprocessor` picks it or the anchor-free
decode of :mod:`.postprocess_bev`."""
from __future__ import annotations

import numpy as np
import torch

from . import GT_RANGE
from .data.anchors import decode_deltas, generate_anchor_grid, \
    generate_labels
from .utils.boxes import (
    boxes_to_corners_3d,
    mask_corners_in_range,
    project_corners,
    sane_size_mask,
    sane_z_mask,
)
from .utils.nms import nms_rotated, nms_rotated_device


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


class AnchorPostprocessor:
    """The anchor grid, the training labels and the multi-agent decode of
    a postprocess config (``anchor_args``, ``target_args``, ``order``,
    ``nms_thresh``).  ``train`` is kept for the JAX API; nothing reads
    it."""

    def __init__(self, params: dict, train: bool = True):
        self.params = params
        self.train = train
        self.order = params.get("order", "hwl")

    def generate_anchor_box(self) -> np.ndarray:
        return generate_anchor_grid(self.params["anchor_args"], self.order)

    def generate_label(self, gt_box_center, anchors, mask) -> dict:
        target = self.params["target_args"]
        return generate_labels(gt_box_center, mask, anchors,
                               target["pos_threshold"],
                               target["neg_threshold"])

    def post_process(self, data_dict: dict, output_dict: dict):
        """Decode every agent's output and merge them.

        ``data_dict`` maps an agent id to ``transformation_matrix`` (4,
        4), ``anchor_box`` (H, W, A, 7) and optionally
        ``no_post_projection``; ``output_dict`` maps it to ``psm`` (1, A,
        H, W) and ``rm`` (1, 7A, H, W), tensors (on the device the decode
        runs on) or numpy arrays.  Returns (corners (N, 8, 3), scores
        (N,)) float32 numpy after a joint host NMS across the agents when
        more than one answers, or (None, None) when no box survives."""
        thresh = float(self.params["nms_thresh"])
        all_corners, all_scores = [], []
        for cav_id, content in data_dict.items():
            if cav_id not in output_dict:
                continue
            psm = torch.as_tensor(output_dict[cav_id]["psm"])
            rm = torch.as_tensor(output_dict[cav_id]["rm"], device=psm.device)
            tf = (np.eye(4) if content.get("no_post_projection")
                  else np.asarray(content["transformation_matrix"]))
            corners, scores, valid = decode_detections_device(
                psm, rm,
                torch.as_tensor(np.asarray(content["anchor_box"]),
                                device=psm.device),
                torch.as_tensor(tf, dtype=torch.float32, device=psm.device),
                score_threshold=float(
                    self.params["target_args"]["score_threshold"]),
                nms_threshold=thresh)
            valid = valid.cpu().numpy()
            all_corners.append(corners.cpu().numpy()[valid])
            all_scores.append(scores.cpu().numpy()[valid])
        if not all_corners:
            return None, None
        corners = np.concatenate(all_corners)
        scores = np.concatenate(all_scores)
        if corners.shape[0] == 0:
            return None, None
        if len(all_corners) > 1:  # joint NMS across agents (late fusion)
            keep = nms_rotated(corners, scores, thresh)
            corners, scores = corners[keep], scores[keep]
        return corners, scores


def build_postprocessor(params: dict, train: bool = True):
    """The postprocessor of ``params["core_method"]``: the anchor decode
    for ``VoxelPostprocessor`` (the default), the anchor-free PIXOR decode
    (:class:`hmvit_tpu_torch.postprocess_bev.BevPostprocessor`) for
    ``BevPostprocessor``."""
    name = params.get("core_method", "VoxelPostprocessor")
    if name == "BevPostprocessor":
        from .postprocess_bev import BevPostprocessor

        return BevPostprocessor(params, train=train)
    return AnchorPostprocessor(params, train=train)
