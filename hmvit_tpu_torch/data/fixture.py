"""Write a synthetic mini-OPV2V dataset to disk, in the layout of the real
release, so that the loader and the trainer run without the dataset (the
port of ``hmvit_tpu/data/fixture.py``).

For the same arguments and seed it writes the same scene, the same frame
yaml content, the same point clouds and the same camera pixels as the
JAX writer, through the port's own codecs (:mod:`.codecs`: no PyYAML,
OpenCV or Pillow), and the same four BEV map rasters a frame
(``bev_dynamic`` and ``bev_visibility_corp``: the vehicles in the
agent's frame; ``bev_static``: a road band; ``bev_lane``: its centre
line; 128 x 128 over +-50 m, 0 / 255 in three equal channels).
"""
from __future__ import annotations

import os

import numpy as np

from ..models.seg_head import rasterize_boxes_to_mask
from ..utils.boxes import boxes_to_corners_3d_np
from . import synthetic
from .codecs import write_png, yaml_dump
from .pcd_io import write_pcd


def write_mini_opv2v(
    root: str,
    num_scenarios: int = 1,
    num_cavs: int = 2,
    num_frames: int = 2,
    num_vehicles: int = 6,
    image_size: int = 64,
    max_points: int = 4096,
    seed: int = 0,
    min_separation: float = 0.0,
    area: float = 30.0,
) -> None:
    """root/scenario_<s>/<641 + agent>/<timestamp>.{yaml,pcd},
    <timestamp>_camera{0..3}.png and <timestamp>_bev_*.png: every agent
    sees the same vehicles; the four cameras of a frame share one random
    image."""
    rng = np.random.default_rng(seed)
    for s in range(num_scenarios):
        vehicles, poses = synthetic.make_scene(
            rng, num_agents=num_cavs, num_vehicles=num_vehicles, area=area,
            min_separation=min_separation)
        scen_dir = os.path.join(root, f"scenario_{s:02d}")
        for ci in range(num_cavs):
            cav_dir = os.path.join(scen_dir, str(641 + ci))
            os.makedirs(cav_dir, exist_ok=True)
            for t in range(num_frames):
                ts = f"{68 + 2 * t:06d}"
                # drift in x / y only: shifting z (or roll / pitch)
                # levitates the ego and pushes the boxes' bottoms past the
                # decode's z filter (z < -3)
                pose = np.asarray(poses[ci], dtype=float).copy()
                pose[0] += t * 0.5
                pose[1] += t * 0.5
                pose = [float(x) for x in pose]
                meta = {
                    "lidar_pose": list(pose),
                    "true_ego_pos": list(pose),
                    "predicted_ego_pos": list(pose),
                    "ego_speed": 5.0,
                    "vehicles": {},
                }
                for mi in range(4):
                    f = image_size / 2.0
                    cam_pose = list(pose)
                    cam_pose[4] = float(pose[4] + 90.0 * mi)
                    meta[f"camera{mi}"] = {
                        "cords": cam_pose,
                        "intrinsic": [[f, 0.0, image_size / 2],
                                      [0.0, f, image_size / 2],
                                      [0.0, 0.0, 1.0]],
                        "extrinsic": np.eye(4).tolist(),
                    }
                for vi, v in enumerate(vehicles):
                    corners = boxes_to_corners_3d_np(v[None], "hwl")[0]
                    meta["vehicles"][100 + vi] = {
                        "location": [float(v[0]), float(v[1]),
                                     float(v[2]) - float(v[3]) / 2],
                        "center": [0.0, 0.0, float(v[3]) / 2],
                        "angle": [0.0, float(np.degrees(v[6])), 0.0],
                        "extent": [float(v[5]) / 2, float(v[4]) / 2,
                                   float(v[3]) / 2],
                        "_corners_world": corners.tolist(),
                    }
                with open(os.path.join(cav_dir, f"{ts}.yaml"), "w") as fh:
                    fh.write(yaml_dump(meta))

                pts, mask = synthetic.lidar_from_boxes(
                    rng, vehicles, pose, max_points=max_points,
                    max_range=60.0)
                write_pcd(os.path.join(cav_dir, f"{ts}.pcd"), pts[mask > 0])

                # drawn as OpenCV's BGR order, stored as RGB
                img = rng.uniform(0, 255, (image_size, image_size, 3)) \
                    .astype(np.uint8)
                for mi in range(4):
                    write_png(os.path.join(cav_dir, f"{ts}_camera{mi}.png"),
                              img[..., ::-1])
                write_bev_maps(cav_dir, ts, synthetic.vehicles_in_agent_frame(
                    vehicles, pose, BEV_MAP_RANGE))


# the BEV rasters' range and size
BEV_MAP_RANGE = [-50, -50, -3, 50, 50, 1]
BEV_MAP_SIZE = 128


def write_bev_maps(cav_dir: str, ts: str, boxes) -> None:
    """A frame's four BEV map rasters: the dynamic map (and the
    visibility map, the same) of ``boxes`` (hwl, the agent's frame), a
    road band over the middle half of the rows and a lane line of two
    rows at its centre."""
    n = BEV_MAP_SIZE
    dyn = rasterize_boxes_to_mask(boxes, BEV_MAP_RANGE, (n, n), "hwl") * 255
    road = np.zeros((n, n), np.uint8)
    road[n // 4: 3 * n // 4] = 255
    lane = np.zeros((n, n), np.uint8)
    lane[n // 2 - 1: n // 2 + 1] = 255
    for name, m in (("bev_dynamic", dyn), ("bev_static", road),
                    ("bev_lane", lane), ("bev_visibility_corp", dyn)):
        write_png(os.path.join(cav_dir, f"{ts}_{name}.png"),
                  np.stack([m] * 3, -1))
