"""Greedy rotated NMS (copied from the port): the fixed-shape device form
(:func:`nms_rotated_device`)."""
from __future__ import annotations

import torch

from .iou import rotated_iou_matrix


def nms_rotated_device(corners, scores, threshold: float,
                       max_keep: int = 256):
    """corners (K, 4, 2) (or (K, 8, 3)), scores (K,) with padded slots at
    score <= 0.  Returns (keep_mask (K,) bool, order (K,) descending-score
    indices).  Boxes whose scores tie may be ordered differently than in
    the JAX package, so compare kept SETS, not orders.

    The JAX form: a fixed ``min(K, max_keep)`` greedy steps, each box of
    rank i suppressing the later-ranked boxes it overlaps if it is still
    alive.  It reads nothing back to the host, so a CUDA graph can
    capture it; a dead box's step changes nothing, so the kept set is
    that of a loop over the live boxes only."""
    corners = corners[..., :4, :2]
    k = corners.shape[0]
    order = torch.argsort(-scores, stable=True)
    sc = corners[order]
    # row i: the later-ranked boxes that box i suppresses
    suppress = torch.triu(rotated_iou_matrix(sc, sc) > threshold, diagonal=1)
    alive = scores[order] > 0
    for i in range(min(k, max_keep)):
        alive.masked_fill_(suppress[i] & alive[i], False)
    keep_mask = torch.zeros(k, dtype=torch.bool, device=scores.device)
    keep_mask[order] = alive
    return keep_mask, order
