"""BEV segmentation head, its loss and ground truth (port of
``hmvit_tpu/models/seg_head.py``): 1x1 conv heads for the dynamic
(vehicles) and / or static (road, lane) maps on an NHWC BEV, a
class-weighted pixel cross-entropy, the host rasterizer of boxes into
the dynamic map, the mean IoU and the probabilities / class maps of the
post-processing.

The heads' outputs stay NHWC, ``(B, H, W, C)``, as the JAX module
returns them (the detection heads' outputs are permuted to NCHW; these
are not).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Conv
from ..parallel.collectives import global_mean
from ..utils.boxes import boxes_to_corners_3d_np, points_in_rotated_box_mask


class BevSegHead(nn.Module):
    """target: 'dynamic', 'static' or 'both'."""

    def __init__(self, cin: int, target: str = "dynamic",
                 dynamic_classes: int = 2, static_classes: int = 3):
        super().__init__()
        self.heads = []
        k = 0
        for key, want, classes in (("dynamic_seg", ("dynamic", "both"),
                                    dynamic_classes),
                                   ("static_seg", ("static", "both"),
                                    static_classes)):
            if target in want:
                conv = Conv(cin, classes, 1)
                self.add_module(f"Conv_{k}", conv)
                self.heads.append((key, conv))
                k += 1

    def forward(self, x) -> dict:
        return {key: conv(x) for key, conv in self.heads}


def seg_loss(output: dict, labels: dict, d_weights: float = 75.0,
             s_weights: float = 15.0):
    """Weighted pixel cross-entropy of the dynamic / static maps: logits
    (B, H, W, C), integer labels (B, H, W); a pixel of class > 0 weighs
    ``d_weights`` (dynamic) or ``s_weights`` (static), the others 1; the
    mean over pixels.  Returns (total, parts with ``total_loss``)."""
    total = 0.0
    parts = {}
    for key, pos_w in (("dynamic_seg", d_weights), ("static_seg",
                                                    s_weights)):
        if key not in output or key not in labels:
            continue
        logits = output[key]
        target = labels[key].long()
        logp = F.log_softmax(logits, dim=-1)
        onehot = F.one_hot(target, logits.shape[-1]).to(logp.dtype)
        weights = torch.where(target > 0, pos_w, 1.0).to(logp.dtype)
        loss = global_mean(-(onehot * logp).sum(-1) * weights)
        parts[key] = loss
        total = total + loss
    parts["total_loss"] = total
    return total, parts


def rasterize_boxes_to_mask(boxes, pc_range, grid_hw, order="hwl"):
    """The dynamic map's ground truth on the host: boxes (N, 7) -> an
    (H, W) uint8 mask, a pixel 1 where its point lies in a box.  The
    points are ``linspace`` over the range with both ends included (not
    cell centres), as in the JAX package."""
    h, w = grid_hw
    mask = np.zeros((h, w), np.uint8)
    if boxes is None or len(boxes) == 0:
        return mask
    xs = np.linspace(pc_range[0], pc_range[3], w)
    ys = np.linspace(pc_range[1], pc_range[4], h)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=1)
    corners = boxes_to_corners_3d_np(np.asarray(boxes), order)
    for c in corners:
        inside = points_in_rotated_box_mask(pts, c[:4, :2])
        mask |= inside.reshape(h, w).astype(np.uint8)
    return mask


def seg_iou(pred, target, num_classes: int = 2) -> dict:
    """IoU of each class and their mean (``miou``) between two class
    maps (numpy arrays or CPU tensors)."""
    ious = {}
    pred = np.asarray(pred)
    target = np.asarray(target)
    for c in range(num_classes):
        inter = ((pred == c) & (target == c)).sum()
        union = ((pred == c) | (target == c)).sum()
        ious[c] = float(inter) / max(float(union), 1.0)
    ious["miou"] = float(np.mean([ious[c] for c in range(num_classes)]))
    return ious


def seg_post_process(output: dict) -> dict:
    """The seg heads' logits (..., H, W, C) -> the dict extended with
    ``<name>_prob`` (softmax) and ``<name>_map`` (argmax class)."""
    out = dict(output)
    for key, name in (("dynamic_seg", "dynamic"), ("static_seg", "static")):
        if key in output:
            prob = torch.softmax(output[key], dim=-1)
            out[f"{name}_prob"] = prob
            out[f"{name}_map"] = torch.argmax(prob, dim=-1)
    return out
