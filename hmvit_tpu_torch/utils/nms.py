"""Greedy rotated NMS (port of ``hmvit_tpu/utils/nms.py``): on the host
(:func:`nms_rotated`, the joint NMS across agents) by the native clipper
or the numpy loop, and fixed-shape on the device
(:func:`nms_rotated_device`)."""
from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import host_build
from . import nms_native
from .iou import rotated_iou_matrix, rotated_iou_matrix_np

BACKENDS = ("auto", "native", "numpy")

def nms_numpy(corners, scores, threshold: float, top: int = 1000):
    """The numpy loop: descending score, ties by ascending index (the
    native clipper's order), at most ``top`` candidates, each pick
    suppressing the later candidates it overlaps by more than
    ``threshold``.  Each pick's IoU row is computed against the
    candidates still alive only (the values of the full matrix, far
    fewer pairs)."""
    corners = np.asarray(corners)[..., :4, :2]
    ixs = np.argsort(-np.asarray(scores), kind="stable")[:top]
    pick = []
    while len(ixs) > 0:
        i, rest = ixs[0], ixs[1:]
        pick.append(i)
        if len(rest) == 0:
            break
        overlap = rotated_iou_matrix_np(corners[i:i + 1], corners[rest])[0]
        ixs = rest[~(overlap > threshold)]
    return np.array(pick, dtype=np.int32)


def nms_rotated(corners, scores, threshold: float, top: int = 1000,
                backend: str = "auto") -> np.ndarray:
    """Greedy rotated NMS on the host: corners (N, 4, 2) or (N, 8, 3),
    scores (N,).  Returns the kept indices in pick order (descending
    score, ties by ascending index, at most ``top`` candidates), int32.

    ``backend="auto"`` runs the native clipper (``utils/nms_native.py``)
    when it builds and the numpy loop otherwise, with one warning naming
    the compiler's error; ``"native"`` raises instead; ``"numpy"`` forces
    the loop.  ``host_build.calls("rotated_nms")`` and ``seconds(...)``
    count the calls each path served."""
    corners = np.asarray(corners)
    scores = np.asarray(scores)
    if backend not in BACKENDS:
        raise ValueError(f"nms backend {backend!r}, not one of {BACKENDS}")
    t0 = time.perf_counter()
    lib = None if backend == "numpy" else nms_native.library(
        require=backend == "native")
    if lib is None:
        keep, served = nms_numpy(corners, scores, threshold, top), "numpy"
    else:
        keep = nms_native.nms_rotated_native(corners, scores, threshold, top,
                                             require=True)
        served = "native"
    host_build.count(nms_native.NAME, served, time.perf_counter() - t0)
    return keep


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
