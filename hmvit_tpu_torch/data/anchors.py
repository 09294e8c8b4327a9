"""The dense anchor grid (numpy, host side) and the anchor delta decode
on tensors: the port's counterparts of ``generate_anchor_grid`` and
``decode_deltas`` of ``hmvit_tpu/data/anchors.py``.  Box order is
``hwl``: (x, y, z, h, w, l, yaw)."""
from __future__ import annotations

import math

import numpy as np
import torch


def generate_anchor_grid(anchor_args: dict, order: str = "hwl") -> np.ndarray:
    """Build the dense BEV anchor grid -> (H', W', num_rot, 7).

    H' = H // feature_stride rows (y), W' = W // feature_stride cols (x):
    the row axis indexes y, matching the head's (H, W) feature map."""
    W, H = anchor_args["W"], anchor_args["H"]
    l, w, h = anchor_args["l"], anchor_args["w"], anchor_args["h"]
    rotations = [math.radians(r) for r in anchor_args["r"]]
    num = anchor_args.get("num", len(rotations))
    if num != len(rotations):
        raise ValueError(f"anchor num {num} != {len(rotations)} rotations")
    vw, vh = anchor_args["vw"], anchor_args["vh"]
    rng = anchor_args["cav_lidar_range"]
    stride = anchor_args.get("feature_stride", 2)

    x = np.linspace(rng[0] + vw, rng[3] - vw, W // stride)
    y = np.linspace(rng[1] + vh, rng[4] - vh, H // stride)
    cx, cy = np.meshgrid(x, y)  # (len(y), len(x))
    cx = np.tile(cx[..., None], num)
    cy = np.tile(cy[..., None], num)
    cz = np.full_like(cx, -1.0)
    ones = np.ones_like(cx)
    r_ = np.stack([np.full_like(cx[..., 0], r) for r in rotations], axis=-1)
    if order == "hwl":
        dims = [ones * h, ones * w, ones * l]
    elif order == "lhw":
        dims = [ones * l, ones * h, ones * w]
    else:
        raise ValueError(f"unsupported anchor order {order!r}")
    return np.stack([cx, cy, cz, *dims, r_], axis=-1)


def decode_deltas(deltas, anchors):
    """(N, num*7, H, W) regression map + (H, W, num, 7) hwl anchors ->
    (N, H*W*num, 7) boxes (VoxelNet delta encoding)."""
    n = deltas.shape[0]
    d = deltas.permute(0, 2, 3, 1).reshape(n, -1, 7)
    a = anchors.reshape(-1, 7)[None]
    diag = torch.sqrt(a[..., 4] ** 2 + a[..., 5] ** 2)
    xy = d[..., 0:2] * diag[..., None] + a[..., 0:2]
    z = d[..., 2:3] * a[..., 3:4] + a[..., 2:3]
    hwl = torch.exp(d[..., 3:6]) * a[..., 3:6]
    yaw = d[..., 6:7] + a[..., 6:7]
    return torch.cat([xy, z, hwl, yaw], dim=-1)
