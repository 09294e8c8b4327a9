"""Stitch dynamic and static segmentation renders side by side (port of
``hmvit_tpu/visualization/merge_maps.py``): for every file name in both
directories, the dynamic image and the static one (resized to the
dynamic one's shape by :func:`hmvit_tpu_torch.data.codecs.
resize_bilinear`, OpenCV's ``INTER_LINEAR``) joined left to right and
written as an RGB PNG.  Images are read as OpenCV reads them in colour
(grey replicated, alpha dropped); a file that is not a PNG is skipped,
as OpenCV skips a file it cannot read.

    python -m hmvit_tpu_torch.visualization.merge_maps --dynamic_dir D
        --static_dir S --out_dir O
"""
from __future__ import annotations

import os

import numpy as np

from ..data.codecs import read_rgb, resize_bilinear, write_png


def _read(path: str):
    try:
        return read_rgb(path)
    except (OSError, ValueError):
        return None


def merge_dynamic_static(dynamic_dir: str, static_dir: str,
                         out_dir: str) -> int:
    """Returns the number of names the two directories share."""
    os.makedirs(out_dir, exist_ok=True)
    names = sorted(set(os.listdir(dynamic_dir)) & set(os.listdir(static_dir)))
    for name in names:
        d = _read(os.path.join(dynamic_dir, name))
        s = _read(os.path.join(static_dir, name))
        if d is None or s is None:
            continue
        if d.shape != s.shape:
            s = resize_bilinear(s, d.shape[:2])
        write_png(os.path.join(out_dir, name), np.concatenate([d, s], axis=1))
    return len(names)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--dynamic_dir", required=True)
    p.add_argument("--static_dir", required=True)
    p.add_argument("--out_dir", required=True)
    a = p.parse_args()
    n = merge_dynamic_static(a.dynamic_dir, a.static_dir, a.out_dir)
    print(f"merged {n} frames -> {a.out_dir}")
