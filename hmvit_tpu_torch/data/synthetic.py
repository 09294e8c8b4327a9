"""Synthetic OPV2V-like scenes (no dataset required): the port's own copy
of ``hmvit_tpu/data/synthetic.py``, numpy only.  The same seed gives the
same batch, array for array, as the JAX package's generator (a test
holds the two equal); the code is kept apart so that the port runs
without the JAX package and shares no helper with the reference it is
tested against.

Physically consistent multi-agent frames: world-frame vehicles, agent
poses, per-agent LiDAR point clouds sampled from vehicle surfaces and
ground, camera tensors, pairwise transforms and padded ground-truth
boxes, in exactly the static, padded shapes the models consume.
"""
from __future__ import annotations

import numpy as np

from ..utils import transforms as T
from ..utils.boxes import boxes_to_corners_3d_np, mask_boxes_outside_range_np


def make_scene(
    rng: np.random.Generator,
    num_agents: int = 4,
    num_vehicles: int = 12,
    area: float = 60.0,
    min_separation: float = 0.0,
):
    """Random world: vehicle boxes (hwl order) + agent poses.

    min_separation > 0 rejection-samples vehicle centers to keep every
    pair at least that far apart (real traffic never interpenetrates;
    overlapping draws cap the achievable AP because rotated NMS merges
    them).  Default 0 preserves the historical draws bit-for-bit.
    """
    vehicles = np.zeros((num_vehicles, 7))
    if min_separation > 0:
        centers = np.empty((0, 2))
        sep = float(min_separation)
        attempts = 0
        while len(centers) < num_vehicles:
            cand = rng.uniform(-area, area, (1, 2))
            if len(centers) == 0 or (
                np.linalg.norm(centers - cand, axis=1).min() >= sep
            ):
                centers = np.concatenate([centers, cand])
            else:
                # infeasible packings (too many vehicles for the area)
                # would loop forever; relax gradually instead
                attempts += 1
                if attempts >= 2000:
                    sep *= 0.9
                    attempts = 0
        vehicles[:, 0] = centers[:, 0]
        vehicles[:, 1] = centers[:, 1]
    else:
        vehicles[:, 0] = rng.uniform(-area, area, num_vehicles)
        vehicles[:, 1] = rng.uniform(-area, area, num_vehicles)
    vehicles[:, 2] = rng.uniform(-0.2, 0.2, num_vehicles)
    vehicles[:, 3] = rng.uniform(1.4, 1.8, num_vehicles)  # h
    vehicles[:, 4] = rng.uniform(1.6, 2.1, num_vehicles)  # w
    vehicles[:, 5] = rng.uniform(3.6, 5.0, num_vehicles)  # l
    vehicles[:, 6] = rng.uniform(-np.pi, np.pi, num_vehicles)

    poses = []
    for i in range(num_agents):
        poses.append(
            [
                rng.uniform(-area / 2, area / 2),
                rng.uniform(-area / 2, area / 2),
                1.9,
                0.0,
                rng.uniform(-180, 180),
                0.0,
            ]
        )
    return vehicles, poses


def lidar_from_boxes(rng, vehicles_world, pose, max_points=8192,
                     pts_per_vehicle=256, ground_points=2048,
                     max_range=80.0):
    """Simulate a point cloud in the agent frame from box surfaces."""
    world_to_agent = np.linalg.inv(T.pose_to_world(pose))
    pts = []
    for v in vehicles_world:
        # sample on the 4 side walls
        t = rng.uniform(0, 1, (pts_per_vehicle, 1))
        wall = rng.integers(0, 4, pts_per_vehicle)
        corners = boxes_to_corners_3d_np(v[None], "hwl")[0]
        a = corners[wall]
        b = corners[(wall + 1) % 4]
        xyz = a + (b - a) * t
        xyz[:, 2] += rng.uniform(0, v[3], pts_per_vehicle)
        pts.append(xyz)
    ground = np.stack(
        [
            rng.uniform(-max_range, max_range, ground_points),
            rng.uniform(-max_range, max_range, ground_points),
            rng.uniform(-0.1, 0.1, ground_points) + 0.0,
        ],
        axis=1,
    )
    pts.append(ground)
    world_pts = np.concatenate(pts)
    agent_pts = T.project_points(world_pts, world_to_agent)
    dist = np.linalg.norm(agent_pts[:, :2], axis=1)
    agent_pts = agent_pts[dist < max_range]

    n = min(len(agent_pts), max_points)
    sel = rng.permutation(len(agent_pts))[:n]
    out = np.zeros((max_points, 4), np.float32)
    out[:n, :3] = agent_pts[sel]
    out[:n, 3] = rng.uniform(0, 1, n)
    mask = np.zeros(max_points, np.float32)
    mask[:n] = 1
    return out, mask


def vehicles_in_agent_frame(vehicles_world, pose, limit_range=None):
    """World hwl boxes -> agent frame (yaw adjusted by the pose yaw)."""
    world_to_agent = np.linalg.inv(T.pose_to_world(pose))
    centers = T.project_points(vehicles_world[:, :3], world_to_agent)
    out = vehicles_world.copy()
    out[:, :3] = centers
    out[:, 6] = vehicles_world[:, 6] - np.radians(pose[4])
    if limit_range is not None:
        keep = mask_boxes_outside_range_np(out, limit_range, "hwl",
                                           min_num_corners=1)
        out = out[keep]
    return out


def make_hetero_batch(
    seed: int = 0,
    batch_size: int = 1,
    max_cav: int = 5,
    num_agents: int = 4,
    max_points: int = 8192,
    image_size: int = 128,
    num_cams: int = 4,
    camera_ratio: float = 0.5,
    ego_mode: str = "mixed",
    max_objects: int = 100,
    lidar_range=(-102.4, -102.4, -3.0, 102.4, 102.4, 1.0),
):
    """Full padded multi-agent batch pytree + ego-frame GT boxes.

    mode: 0 = camera, 1 = lidar.
    """
    rng = np.random.default_rng(seed)
    out_frames = []
    gt_list = []
    for _ in range(batch_size):
        vehicles, poses = make_scene(rng, num_agents)
        ego_pose = poses[0]

        mode = (rng.uniform(0, 1, max_cav) >= camera_ratio).astype(np.int32)
        if ego_mode == "camera":
            mode[0] = 0
        elif ego_mode == "lidar":
            mode[0] = 1
        # padded slots count as lidar (empty point sets are one cheap
        # all-masked pillar pass; keeps serving camera-buckets honest)
        mode[num_agents:] = 1

        points = np.zeros((max_cav, max_points, 4), np.float32)
        points_mask = np.zeros((max_cav, max_points), np.float32)
        cams = np.zeros(
            (max_cav, num_cams, image_size, image_size, 3), np.float32
        )
        intrinsics = np.tile(np.eye(3, dtype=np.float32),
                             (max_cav, num_cams, 1, 1))
        extrinsics = np.tile(np.eye(4, dtype=np.float32),
                             (max_cav, num_cams, 1, 1))
        agent_mask = np.zeros(max_cav, np.float32)
        pairwise = np.tile(np.eye(4, dtype=np.float32),
                           (max_cav, max_cav, 1, 1))
        transforms_to_ego = np.tile(np.eye(4, dtype=np.float32),
                                    (max_cav, 1, 1))

        pw = T.pairwise_transforms(poses, max_cav)
        pairwise[:] = pw.astype(np.float32)
        for i, pose in enumerate(poses):
            agent_mask[i] = 1
            transforms_to_ego[i] = T.pose_to_pose(pose, ego_pose).astype(
                np.float32
            )
            points[i], points_mask[i] = lidar_from_boxes(
                rng, vehicles, pose, max_points
            )
            cams[i] = rng.uniform(0, 1, cams[i].shape)
            f = image_size / (2 * np.tan(np.radians(50)))
            intrinsics[i, :, 0, 0] = f
            intrinsics[i, :, 1, 1] = f
            intrinsics[i, :, :2, 2] = image_size / 2

        prior = np.zeros((max_cav, 3), np.float32)
        prior[:num_agents, 0] = rng.uniform(0, 1, num_agents)  # v/30
        prior[1:num_agents, 1] = rng.integers(0, 3, max(num_agents - 1, 0))
        gt_ego = vehicles_in_agent_frame(vehicles, ego_pose, lidar_range)
        gt_padded = np.zeros((max_objects, 7), np.float32)
        gt_mask = np.zeros(max_objects, np.float32)
        n = min(len(gt_ego), max_objects)
        gt_padded[:n] = gt_ego[:n]
        gt_mask[:n] = 1

        out_frames.append(
            {
                "points": points,
                "points_mask": points_mask,
                "camera": cams,
                "intrinsics": intrinsics,
                "extrinsics": extrinsics,
                "mode": mode,
                "agent_mask": agent_mask,
                "prior_encoding": prior,
                "pairwise_t_matrix": pairwise,
                "transformation_matrix": transforms_to_ego,
                "object_bbx_center": gt_padded,
                "object_bbx_mask": gt_mask,
                "record_len": np.int32(num_agents),
            }
        )
        gt_list.append(gt_ego)

    batch = {
        k: np.stack([f[k] for f in out_frames]) for k in out_frames[0]
    }
    return batch, gt_list
