"""Render the ``<i>_pred.npy`` / ``<i>_gt.npy`` pairs that ``inference
--save_npy`` writes (port of ``hmvit_tpu/visualization/vis_npy.py``):
a BEV PNG a pair and one 3D HTML sequence.

    python -m hmvit_tpu_torch.visualization.vis_npy <npy_dir> [out_dir]
"""
from __future__ import annotations

import glob
import os
import sys

import numpy as np

from .vis import visualize_bev
from .viewer3d import export_sequence_html

DEFAULT_RANGE = (-102.4, -102.4, -3.0, 102.4, 102.4, 1.0)


def render_npy_dir(npy_dir: str, out_dir: str | None = None,
                   lidar_range=DEFAULT_RANGE) -> list:
    """Render every pred / gt pair of ``npy_dir`` into ``out_dir``
    (default ``npy_dir/vis``) and the pairs as ``sequence.html`` there;
    returns the PNG paths."""
    out_dir = out_dir or os.path.join(npy_dir, "vis")
    os.makedirs(out_dir, exist_ok=True)
    paths, frames = [], []
    for pred_path in sorted(glob.glob(os.path.join(npy_dir, "*_pred.npy"))):
        stem = os.path.basename(pred_path)[:-len("_pred.npy")]
        gt_path = os.path.join(npy_dir, f"{stem}_gt.npy")
        pred = np.load(pred_path)
        gt = np.load(gt_path) if os.path.exists(gt_path) else None
        png = os.path.join(out_dir, f"{stem}.png")
        visualize_bev(np.zeros((0, 4), np.float32), pred, gt,
                      list(lidar_range), save_path=png)
        paths.append(png)
        frames.append({"points": np.zeros((0, 4), np.float32),
                       "pred_corners": pred, "gt_corners": gt})
    if frames:
        export_sequence_html(os.path.join(out_dir, "sequence.html"), frames)
    return paths


if __name__ == "__main__":
    out = sys.argv[2] if len(sys.argv) > 2 else None
    print("\n".join(render_npy_dir(sys.argv[1], out)))
