"""Evaluation sweep over the (camera_to_lidar_ratio x ego_mode) grid (port
of ``hmvit_tpu/tools/sweep.py``): one ``tools.inference`` run per cell in
one process, the cells where the fleet cannot host the ego's modality
skipped (an all-lidar fleet with a camera ego and the reverse), one
``sweep.json`` in the run directory and an AP table.  Flags it does not
know go to every cell's inference run (``--cpu``, ``--synthetic``,
``--serving_buckets``, ...).

    python -m hmvit_tpu_torch.tools.sweep --model_dir runs/<run>
        [--ratios 0,0.5,1] [--ego_modes lidar,camera,mixed] [...]
"""
from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser("hmvit_tpu_torch eval sweep",
                                allow_abbrev=False)
    p.add_argument("--model_dir", required=True)
    p.add_argument("--ratios", default="0,0.5,1")
    p.add_argument("--ego_modes", default="lidar,camera,mixed")
    return p.parse_known_args(argv)


def main(argv=None):
    args, passthrough = parse_args(argv)
    from . import inference

    ratios = [float(r) for r in args.ratios.split(",") if r != ""]
    ego_modes = [m for m in args.ego_modes.split(",") if m]

    grid = {}
    for ratio in ratios:
        for ego in ego_modes:
            if (ratio == 0.0 and ego == "camera") or (
                    ratio == 1.0 and ego == "lidar"):
                continue
            cell = f"ratio={ratio:g},ego={ego}"
            print(f"=== sweep cell {cell} ===")
            grid[cell] = inference.main([
                "--model_dir", args.model_dir,
                "--camera_to_lidar_ratio", str(ratio),
                "--ego_mode", ego,
                *passthrough,
            ])

    out_path = os.path.join(args.model_dir, "sweep.json")
    with open(out_path, "w") as f:
        json.dump(grid, f, indent=2)

    print(f"{'cell':26s} {'AP@0.3':>7s} {'AP@0.5':>7s} {'AP@0.7':>7s}")
    for cell, res in grid.items():
        iou = res.get("iou", {})
        print(f"{cell:26s} {iou.get('ap_30', float('nan')):7.3f} "
              f"{iou.get('ap_50', float('nan')):7.3f} "
              f"{iou.get('ap_70', float('nan')):7.3f}")
    print(f"sweep -> {out_path}")
    return grid


if __name__ == "__main__":
    main()
