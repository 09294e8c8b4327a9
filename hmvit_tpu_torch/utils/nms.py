"""Fixed-shape greedy rotated NMS on the device (port of
``hmvit_tpu/utils/nms.py::nms_rotated_device``)."""
from __future__ import annotations

import torch

from .iou import rotated_iou_matrix


def nms_rotated_device(corners, scores, threshold: float,
                       max_keep: int = 256):
    """corners (K, 4, 2) (or (K, 8, 3)), scores (K,) with padded slots at
    score <= 0.  Returns (keep_mask (K,) bool, order (K,) descending-score
    indices).  Boxes whose scores tie may be ordered differently than in
    the JAX package, so compare kept SETS, not orders."""
    corners = corners[..., :4, :2]
    k = corners.shape[0]
    order = torch.argsort(-scores, stable=True)
    sc = corners[order]
    suppress_next = rotated_iou_matrix(sc, sc) > threshold
    alive = scores[order] > 0
    later = torch.arange(k, device=scores.device)
    # only the leading live boxes can suppress anything: one host read of
    # their count bounds the greedy loop (same result as running all K)
    n_live = int(alive.sum())
    for i in range(min(n_live, max_keep)):
        kill = suppress_next[i] & (later > i) & alive[i]
        alive = alive & ~kill
    keep_mask = torch.zeros(k, dtype=torch.bool, device=scores.device)
    keep_mask[order] = alive
    return keep_mask, order
