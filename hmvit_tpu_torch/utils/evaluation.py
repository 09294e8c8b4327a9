"""Detection metrics: VOC-2010 AP over BEV polygon IoU and center
distance (the port's own copy of ``hmvit_tpu/utils/evaluation.py``, held
equal to it by ``tests/test_torch_evaluation.py``).

Per-frame greedy matching in descending-score order, cumulative
precision / recall, VOC-2010 interpolated AP; polygon IoU is the
analytic quad intersection of :func:`..utils.iou.rotated_iou_matrix_np`.
"""
from __future__ import annotations

import numpy as np

from .boxes import corners_to_boxes
from .iou import rotated_iou_matrix_np

IOU_THRESHOLDS = (0.3, 0.5, 0.7)
DISTANCE_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)


def new_result_stat(mode: str = "both") -> dict:
    stat = {}
    if mode in ("iou", "both"):
        stat["iou"] = {t: {"tp": [], "fp": [], "gt": 0} for t in IOU_THRESHOLDS}
    if mode in ("distance", "both"):
        stat["distance"] = {
            t: {"tp": [], "fp": [], "gt": 0} for t in DISTANCE_THRESHOLDS
        }
    return stat


def voc_ap(rec: list, prec: list):
    """VOC-2010 interpolated average precision."""
    mrec = [0.0] + list(rec) + [1.0]
    mpre = [0.0] + list(prec) + [0.0]
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    ap = 0.0
    for i in range(1, len(mrec)):
        if mrec[i] != mrec[i - 1]:
            ap += (mrec[i] - mrec[i - 1]) * mpre[i]
    return ap, mrec, mpre


def accumulate_tp_fp_iou(det_corners, det_scores, gt_corners, stat, thresh):
    """One frame of IoU-mode matching into ``stat[thresh]``."""
    fp, tp = [], []
    gt = 0 if gt_corners is None else int(gt_corners.shape[0])
    if det_corners is not None and det_corners.shape[0] > 0:
        det_corners = np.asarray(det_corners)
        order = np.argsort(-np.asarray(det_scores))
        remaining = list(range(gt))
        iou_all = (
            rotated_iou_matrix_np(det_corners, gt_corners)
            if gt > 0
            else np.zeros((det_corners.shape[0], 0))
        )
        for det_idx in order:
            ious = iou_all[det_idx, remaining] if remaining else np.array([])
            if len(remaining) == 0 or ious.max() < thresh:
                fp.append(1)
                tp.append(0)
                continue
            fp.append(0)
            tp.append(1)
            remaining.pop(int(np.argmax(ious)))
    stat[thresh]["fp"] += fp
    stat[thresh]["tp"] += tp
    stat[thresh]["gt"] += gt


def accumulate_tp_fp_distance(det_corners, det_scores, gt_corners, stat,
                              dist_th):
    """One frame of nuScenes-style center-distance matching."""
    fp, tp = [], []
    gt = 0 if gt_corners is None else int(gt_corners.shape[0])
    if det_corners is not None and det_corners.shape[0] > 0:
        det_centers = corners_to_boxes(np.asarray(det_corners))[:, :2]
        gt_centers = (
            corners_to_boxes(np.asarray(gt_corners))[:, :2]
            if gt > 0
            else np.zeros((0, 2))
        )
        order = np.argsort(-np.asarray(det_scores))
        dist = np.linalg.norm(
            gt_centers[None, :, :] - det_centers[:, None, :], axis=-1
        )
        taken: set = set()
        for det_idx in order:
            best, best_gt = np.inf, None
            for g in range(gt):
                if g not in taken and dist[det_idx, g] < best:
                    best, best_gt = dist[det_idx, g], g
            if best < dist_th:
                taken.add(best_gt)
                tp.append(1)
                fp.append(0)
            else:
                tp.append(0)
                fp.append(1)
    stat[dist_th]["fp"] += fp
    stat[dist_th]["tp"] += tp
    stat[dist_th]["gt"] += gt


def accumulate_frame(det_corners, det_scores, gt_corners, result_stat):
    """Accumulate one frame into every configured mode/threshold."""
    if "iou" in result_stat:
        for t in IOU_THRESHOLDS:
            accumulate_tp_fp_iou(det_corners, det_scores, gt_corners,
                                 result_stat["iou"], t)
    if "distance" in result_stat:
        for t in DISTANCE_THRESHOLDS:
            accumulate_tp_fp_distance(det_corners, det_scores, gt_corners,
                                      result_stat["distance"], t)


def calculate_ap(stat: dict, thresh):
    entry = stat[thresh]
    fp = np.cumsum(entry["fp"]).astype(float)
    tp = np.cumsum(entry["tp"]).astype(float)
    gt_total = max(entry["gt"], 1)
    rec = (tp / gt_total).tolist()
    prec = (tp / np.maximum(fp + tp, 1e-9)).tolist()
    return voc_ap(rec, prec)


def final_results(result_stat: dict) -> dict:
    """Summarize accumulated stats into the eval dict (AP@x, dAP@x, mAP)."""
    out = {}
    if "iou" in result_stat:
        out["iou"] = {
            f"ap_{int(t * 100)}": calculate_ap(result_stat["iou"], t)[0]
            for t in IOU_THRESHOLDS
        }
    if "distance" in result_stat:
        aps = {}
        for t in DISTANCE_THRESHOLDS:
            aps[f"ap_{t}"] = calculate_ap(result_stat["distance"], t)[0]
        aps["map"] = float(np.mean(list(aps.values())))
        out["distance"] = aps
    return out
