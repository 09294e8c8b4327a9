"""World-level data augmentation (the port's own copy of
``hmvit_tpu/data/augment.py``, numpy): flip, global rotation and global
scaling applied jointly to points and boxes, from a config queue whose
entries name the transform and its parameter range."""
from __future__ import annotations

import numpy as np


def random_flip(points, boxes, rng, axes=("x",)):
    for axis in axes:
        if rng.uniform() < 0.5:
            continue
        if axis == "x":  # flip across the x axis (negate y)
            points[..., 1] = -points[..., 1]
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
        elif axis == "y":
            points[..., 0] = -points[..., 0]
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = np.pi - boxes[:, 6]
    return points, boxes


def global_rotation(points, boxes, rng, rot_range=(-np.pi / 4, np.pi / 4)):
    angle = rng.uniform(*rot_range)
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s], [-s, c]])
    points[..., :2] = points[..., :2] @ rot
    boxes[:, :2] = boxes[:, :2] @ rot
    boxes[:, 6] += angle
    return points, boxes


def global_scaling(points, boxes, rng, scale_range=(0.95, 1.05)):
    s = rng.uniform(*scale_range)
    points[..., :3] *= s
    boxes[:, :6] *= s
    return points, boxes


_AUGMENTS = {
    "random_world_flip": lambda p, b, r, cfg: random_flip(
        p, b, r, cfg.get("ALONG_AXIS_LIST", ["x"])),
    "random_world_rotation": lambda p, b, r, cfg: global_rotation(
        p, b, r, tuple(cfg.get("WORLD_ROT_ANGLE", [-np.pi / 4, np.pi / 4]))),
    "random_world_scaling": lambda p, b, r, cfg: global_scaling(
        p, b, r, tuple(cfg.get("WORLD_SCALE_RANGE", [0.95, 1.05]))),
}


class DataAugmentor:
    """Queue of world-level augmentations from a config list."""

    def __init__(self, config_list: list, train: bool = True, seed=None):
        self.queue = []
        if train:
            for entry in config_list or []:
                name = entry["NAME"] if isinstance(entry, dict) else entry
                cfg = entry if isinstance(entry, dict) else {}
                self.queue.append((_AUGMENTS[name], cfg))
        self.rng = np.random.default_rng(seed)

    def __call__(self, points: np.ndarray, boxes: np.ndarray):
        points = np.array(points, copy=True)
        boxes = np.array(boxes, copy=True)
        for fn, cfg in self.queue:
            points, boxes = fn(points, boxes, self.rng, cfg)
        return points, boxes
