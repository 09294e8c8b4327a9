"""Greedy rotated NMS (port of ``hmvit_tpu/utils/nms.py``): on the host
in numpy (:func:`nms_rotated`, the joint NMS across agents) and
fixed-shape on the device (:func:`nms_rotated_device`)."""
from __future__ import annotations

import numpy as np
import torch

from .iou import rotated_iou_matrix, rotated_iou_matrix_np


def nms_rotated(corners, scores, threshold: float,
                top: int = 1000) -> np.ndarray:
    """Greedy rotated NMS on the host: corners (N, 4, 2) or (N, 8, 3),
    scores (N,).  Returns the kept indices in pick order (descending
    score, at most ``top`` candidates), int32.

    This is the JAX function's ``backend="numpy"`` loop.  Its default
    backend binds a native clipper (``native/rotated_nms.cpp``) that
    ``tests/test_native_nms.py`` holds to this loop's pick order; the port
    does not bind it, so it has no ``backend`` argument."""
    corners = np.asarray(corners)
    scores = np.asarray(scores)
    if corners.shape[0] == 0:
        return np.array([], dtype=np.int32)
    iou = rotated_iou_matrix_np(corners, corners)
    ixs = scores.argsort()[::-1][:top]
    pick = []
    while len(ixs) > 0:
        i = ixs[0]
        pick.append(i)
        overlap = iou[i, ixs[1:]]
        remove = np.where(overlap > threshold)[0] + 1
        ixs = np.delete(ixs, remove)
        ixs = np.delete(ixs, 0)
    return np.array(pick, dtype=np.int32)


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
