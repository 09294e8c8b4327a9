"""Anchor-free BEV post-processing of the PIXOR family (port of
``hmvit_tpu/postprocess_bev.py``).

Each label cell inside a box carries ``(1, cos yaw, sin yaw, x - cx,
y - cy, log l, log w)``, normalised by the target statistics
(:func:`bev_label_map`, host numpy, in the input pipeline).  The decode
inverts it on the device at a fixed shape (:func:`decode_bev_device`:
sigmoid score threshold, a static-K top-k, ``atan2`` / ``exp``, the
corners projected by the agent's transform); :class:`BevPostprocessor`
decodes every agent, joins them by one host rotated NMS and clips to
the ground-truth range.
"""
from __future__ import annotations

import numpy as np
import torch

from . import GT_RANGE
from .utils.boxes import boxes_to_corners_3d_np, points_in_rotated_box_mask
from .utils.nms import nms_rotated

# target statistics of the regression channels, as the JAX package has
# them (from the reference), so that label maps interchange
TARGET_MEAN = np.array([0.008, 0.001, 0.202, 0.2, 0.43, 1.368])
TARGET_STD = np.array([0.866, 0.5, 0.954, 0.668, 0.09, 0.111])


def bev_label_map(gt_box_center: np.ndarray, mask: np.ndarray,
                  geometry: dict) -> dict:
    """The dense training targets of one frame: gt_box_center (max_num,
    7) lwh boxes in the frame's lidar coordinates, mask (max_num,)
    validity.  Returns ``{"label_map": (7, H, W) float32, "bev_corners":
    (n, 4, 2)}``: cell (i, j) inside a box's corner polygon (in label
    cells) gets occupancy 1 and the box's regression target less the
    cell's continuous coordinate; a later box overwrites an earlier one
    where they overlap."""
    valid = np.asarray(gt_box_center)[np.asarray(mask) == 1]
    res = float(geometry["res"])
    ds = int(geometry["downsample_rate"])
    h, w = int(geometry["label_shape"][0]), int(geometry["label_shape"][1])
    origin = np.array([geometry["L1"], geometry["W1"]])[None, :]

    label_map = np.zeros((h, w, 7), np.float64)
    corners = boxes_to_corners_3d_np(valid, "lwh")[:, :4, :2]

    cells = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"),
                     axis=-1).reshape(-1, 2).astype(np.float64)
    corners_dist = (corners - origin[None]) / res / ds
    origin_dist = origin / res / ds
    yaw = valid[:, 6] if valid.shape[0] else np.zeros((0,))
    reg = np.column_stack([
        np.cos(yaw), np.sin(yaw), valid[:, 0], valid[:, 1],
        valid[:, 3], valid[:, 4],
    ]) if valid.shape[0] else np.zeros((0, 6))

    for i in range(valid.shape[0]):
        inside = points_in_rotated_box_mask(cells, corners_dist[i])
        pts = cells[inside]
        continuous = (pts + origin_dist) * res * ds
        target = np.repeat(reg[i][None], pts.shape[0], axis=0)
        target[:, 2:4] -= continuous
        target[:, 4:] = np.log(target[:, 4:])
        ii, jj = pts[:, 0].astype(int), pts[:, 1].astype(int)
        label_map[ii, jj, 0] = 1.0
        label_map[ii, jj, 1:] = target

    label_map[..., 1:] = (label_map[..., 1:] - TARGET_MEAN) / TARGET_STD
    return {
        "label_map": label_map.transpose(2, 0, 1).astype(np.float32),
        "bev_corners": corners,
    }


def denormalize_reg_map(reg_map):
    """Undo the target normalisation of (..., 6) regression values."""
    std = torch.as_tensor(TARGET_STD, dtype=reg_map.dtype,
                          device=reg_map.device)
    mean = torch.as_tensor(TARGET_MEAN, dtype=reg_map.dtype,
                           device=reg_map.device)
    return reg_map * std + mean


# corners of a unit box, walked as boxes2d_to_corners2d does
_TEMPLATE = ((0.5, -0.5), (0.5, 0.5), (-0.5, 0.5), (-0.5, -0.5))


def decode_bev_device(cls_map, reg_map, transform, geometry: dict,
                      score_threshold: float = 0.5, max_boxes: int = 256):
    """One agent's decode on the device of ``cls_map``: cls_map (1, H, W)
    or (H, W) logits, reg_map (6, H, W), transform (4, 4) to the ego
    frame (tensors or numpy).  Returns fixed-shape (corners (K, 4, 2)
    float32, scores (K,), valid (K,) bool), K = min(max_boxes, H W); the
    NMS comes after the agents are joined."""
    cls_map = torch.as_tensor(cls_map)
    dev = cls_map.device
    res, ds = float(geometry["res"]), int(geometry["downsample_rate"])
    step = res * ds
    gx = np.arange(geometry["L1"], geometry["L2"], step, dtype=np.float32)
    gy = np.arange(geometry["W1"], geometry["W2"], step, dtype=np.float32)
    grid_x, grid_y = np.meshgrid(gx, gy, indexing="ij")
    f32 = torch.float32
    prob = torch.sigmoid(cls_map.reshape(-1))
    reg = denormalize_reg_map(
        torch.as_tensor(reg_map, device=dev).reshape(6, -1).T.to(f32))
    cos_t, sin_t, dx_off, dy_off, log_dx, log_dy = reg.unbind(-1)
    yaw = torch.atan2(sin_t, cos_t)
    dx, dy = torch.exp(log_dx), torch.exp(log_dy)
    cx = torch.as_tensor(grid_x.reshape(-1), device=dev) + dx_off
    cy = torch.as_tensor(grid_y.reshape(-1), device=dev) + dy_off

    score = torch.where(prob > score_threshold, prob, torch.zeros_like(prob))
    k = min(max_boxes, score.shape[0])
    top_score, top_idx = torch.topk(score, k)

    template = torch.tensor(_TEMPLATE, dtype=f32).to(dev)
    local = template[None] * torch.stack([dx[top_idx], dy[top_idx]],
                                         dim=-1)[:, None, :]
    ca, sa = torch.cos(yaw[top_idx])[:, None], torch.sin(yaw[top_idx])[:,
                                                                        None]
    rx = local[..., 0] * ca - local[..., 1] * sa + cx[top_idx, None]
    ry = local[..., 0] * sa + local[..., 1] * ca + cy[top_idx, None]
    # z = 0, projected to the ego frame (elementwise: never TF32)
    t = torch.as_tensor(transform, device=dev).to(f32)
    corners = torch.stack(
        [t[i, 0] * rx + t[i, 1] * ry + t[i, 3] for i in range(2)], dim=-1)
    return corners, top_score, top_score > 0


def _range_mask_2d(corners2d: np.ndarray) -> np.ndarray:
    """Every corner inside GT_RANGE's xy."""
    lo = np.asarray(GT_RANGE[:2])[None, None]
    hi = np.asarray(GT_RANGE[3:5])[None, None]
    return np.all((corners2d >= lo) & (corners2d <= hi), axis=(1, 2))


class BevPostprocessor:
    """The anchor-free family's labels and decode (``geometry_param``,
    ``target_args.score_threshold``, ``nms_thresh``, ``order``).
    ``train`` is kept for the JAX API; nothing reads it."""

    def __init__(self, params: dict, train: bool = True):
        self.params = params
        self.train = train
        self.geometry = params["geometry_param"]
        self.order = params.get("order", "lwh")

    def generate_anchor_box(self):
        return None  # anchor-free

    def generate_label(self, gt_box_center, mask, **_):
        return bev_label_map(gt_box_center, mask, self.geometry)

    @staticmethod
    def collate_batch(label_list):
        return {
            "label_map": np.stack([x["label_map"] for x in label_list]),
            "bev_corners": [x["bev_corners"] for x in label_list],
        }

    def post_process(self, data_dict: dict, output_dict: dict):
        """Decode every agent of ``data_dict`` (agent id ->
        ``transformation_matrix``) from ``output_dict`` (agent id ->
        ``cls`` (1, 1, H, W), ``reg`` (1, 6, H, W), tensors or numpy),
        join them by a host NMS and keep the boxes inside the ground-truth
        range.  Returns (corners (N, 4, 2), scores (N,)) numpy, or (None,
        None)."""
        threshold = self.params.get("target_args", {}).get(
            "score_threshold", 0.5)
        all_corners, all_scores = [], []
        for cav_id, content in data_dict.items():
            out = output_dict[cav_id]
            corners, scores, valid = decode_bev_device(
                out["cls"], out["reg"], content["transformation_matrix"],
                self.geometry, score_threshold=threshold)
            keep = valid.cpu().numpy()
            if keep.any():
                all_corners.append(corners.cpu().numpy()[keep])
                all_scores.append(scores.float().cpu().numpy()[keep])
        if not all_corners:
            return None, None
        corners = np.concatenate(all_corners, 0)
        scores = np.concatenate(all_scores, 0)
        pick = nms_rotated(corners, scores,
                           self.params.get("nms_thresh", 0.15))
        corners, scores = corners[pick], scores[pick]
        mask = _range_mask_2d(corners)
        return corners[mask], scores[mask]
