"""Sequence rendering (port of ``hmvit_tpu/visualization/sequence.py``):
a scenario's frames as numbered BEV PNGs, the interactive 3D HTML viewer
and, where Pillow is installed, an animated GIF.

    from hmvit_tpu_torch.visualization.sequence import render_sequence
    render_sequence(dataset, "out/seq")
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.boxes import boxes_to_corners_3d_np
from .vis import visualize_bev
from .viewer3d import export_sequence_html


def vis_frame(dataset, idx: int) -> dict:
    """Frame ``idx`` for display: every agent's cloud merged in the ego
    frame (:meth:`~hmvit_tpu_torch.data.opv2v.HeteroCooperativeDataset.
    early_fusion_frame`) and the ego-frame ground-truth corners."""
    frame = dataset.early_fusion_frame(idx)
    pts = frame["points"][0][frame["points_mask"][0] > 0]
    boxes = frame["object_bbx_center"][frame["object_bbx_mask"] > 0]
    corners = (boxes_to_corners_3d_np(boxes, dataset.order)
               if len(boxes) else np.zeros((0, 8, 3)))
    return {"points": pts, "gt_corners": corners}


def render_sequence(dataset, out_dir: str, indices=None, pred_fn=None,
                    gif: bool = True, gif_name: str = "sequence.gif",
                    html: bool = True) -> list:
    """Render frames to ``out_dir/frame_%05d.png``, the viewer to
    ``out_dir/sequence.html`` (``html``) and, where Pillow is installed,
    the PNGs as ``out_dir/<gif_name>`` (``gif``; without Pillow no GIF is
    written, as in the JAX module).

    pred_fn: optional ``idx -> (pred_corners, scores)`` to overlay
    detections.  Returns the PNG paths."""
    os.makedirs(out_dir, exist_ok=True)
    indices = range(len(dataset)) if indices is None else indices
    paths, html_frames = [], []
    for i in indices:
        data = vis_frame(dataset, int(i))
        pred, scores = (pred_fn(int(i)) if pred_fn is not None
                        else (None, None))
        path = os.path.join(out_dir, f"frame_{int(i):05d}.png")
        visualize_bev(data["points"], pred, data["gt_corners"],
                      dataset.lidar_range, save_path=path)
        paths.append(path)
        if html:
            html_frames.append({"points": data["points"],
                                "pred_corners": pred,
                                "gt_corners": data["gt_corners"],
                                "scores": scores})
    if html and html_frames:
        export_sequence_html(os.path.join(out_dir, "sequence.html"),
                             html_frames)
    if gif and paths:
        try:
            from PIL import Image
        except ImportError:
            return paths  # Pillow is optional; the PNGs remain
        frames = [Image.open(p) for p in paths]
        frames[0].save(os.path.join(out_dir, gif_name), save_all=True,
                       append_images=frames[1:], duration=200, loop=0)
    return paths
