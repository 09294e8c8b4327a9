"""The anchor delta decode on tensors (port of ``decode_deltas`` of
``hmvit_tpu/data/anchors.py``; the anchor grid itself is built on the
host by that module's numpy ``generate_anchor_grid``).  Box order is
``hwl``: (x, y, z, h, w, l, yaw)."""
from __future__ import annotations

import torch


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
