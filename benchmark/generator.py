"""The benchmark's traffic generator: requests of the port's format from a
seed and a traffic file's parameters.

A frozen copy of ``hmvit_tpu_torch/data/synthetic.py::make_hetero_batch``
(numpy only), changed where the served scenes were not a deployment's:

* the agents lie within ``comm_range_m`` of the ego (OPV2V's 70 m), at a
  distance drawn uniformly over the disc;
* every lidar agent's cloud fills all ``max_points`` slots (the
  published hypes' 60 000), as vehicle surfaces and ground returns
  inside the lidar range (+-102.4 m), in the agent's frame;
* a lidar agent has no images (its camera slots are zeros) and a camera
  agent no points, as in a real fleet; the modality of every slot comes
  from the traffic file, not from a draw;
* every agent carries the camera rig the traffic file gives
  (``camera_mounts``: each camera's ``[x, y, z, yaw]`` in the vehicle's
  frame, ``lidar_mount``: the lidar's ``[x, y, z]``, from which the
  camera -> lidar extrinsics follow; ``camera_image_wh`` and
  ``camera_fov_deg``: the recorded image's pinhole, whose intrinsics are
  scaled to the square ``image_size`` the images are resized to), where
  the original gave all four cameras the identity.

One request is one fleet (batch 1).  :func:`make_pool` draws the cell's
pool of distinct requests: request ``i`` from
``numpy.random.default_rng([seed, i])``, so the same seed gives the same
pool, array for array, and any seed below 2**63 works.
"""
from __future__ import annotations

import numpy as np

from .reference.utils.boxes import (
    boxes_to_corners_3d_np,
    mask_boxes_outside_range_np,
)

LIDAR_RANGE = (-102.4, -102.4, -3.0, 102.4, 102.4, 1.0)


def pose_to_world(pose) -> np.ndarray:
    """4x4 transform from a CARLA pose ``[x, y, z, roll, yaw, pitch]``
    (degrees) to the world frame."""
    x, y, z, roll, yaw, pitch = np.asarray(pose, dtype=np.float64)[:6]
    cy, sy = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
    cr, sr = np.cos(np.radians(roll)), np.sin(np.radians(roll))
    cp, sp = np.cos(np.radians(pitch)), np.sin(np.radians(pitch))
    m = np.identity(4)
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    m[0, 0] = cp * cy
    m[0, 1] = cy * sp * sr - sy * cr
    m[0, 2] = -cy * sp * cr - sy * sr
    m[1, 0] = sy * cp
    m[1, 1] = sy * sp * sr + cy * cr
    m[1, 2] = -sy * sp * cr + cy * sr
    m[2, 0] = sp
    m[2, 1] = -cp * sr
    m[2, 2] = cp * cr
    return m


def project_points(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    pts = np.hstack([points[:, :3], np.ones((points.shape[0], 1))])
    return (pts @ transform.T)[:, :3]


def make_scene(rng, num_agents: int, num_vehicles: int, area: float,
               comm_range: float):
    """World vehicle boxes (hwl order) around the ego, and agent poses:
    the ego at the origin's neighbourhood, every other agent within
    ``comm_range`` of it."""
    vehicles = np.zeros((num_vehicles, 7))
    vehicles[:, 0] = rng.uniform(-area, area, num_vehicles)
    vehicles[:, 1] = rng.uniform(-area, area, num_vehicles)
    vehicles[:, 2] = rng.uniform(-0.2, 0.2, num_vehicles)
    vehicles[:, 3] = rng.uniform(1.4, 1.8, num_vehicles)  # h
    vehicles[:, 4] = rng.uniform(1.6, 2.1, num_vehicles)  # w
    vehicles[:, 5] = rng.uniform(3.6, 5.0, num_vehicles)  # l
    vehicles[:, 6] = rng.uniform(-np.pi, np.pi, num_vehicles)
    ego = np.array([rng.uniform(-5, 5), rng.uniform(-5, 5)])
    poses = [[ego[0], ego[1], 1.9, 0.0, rng.uniform(-180, 180), 0.0]]
    for _ in range(num_agents - 1):
        r = comm_range * np.sqrt(rng.uniform(0, 1))
        a = rng.uniform(-np.pi, np.pi)
        poses.append([ego[0] + r * np.cos(a), ego[1] + r * np.sin(a), 1.9,
                      0.0, rng.uniform(-180, 180), 0.0])
    return vehicles, poses


def lidar_cloud(rng, vehicles, pose, max_points: int, pts_per_vehicle: int):
    """(max_points, 4) points in the agent's frame, every slot filled:
    the vehicle surfaces that lie inside the lidar range, then ground
    returns over the range for the rest; intensity uniform."""
    world_to_agent = np.linalg.inv(pose_to_world(pose))
    walls = []
    for v in vehicles:
        t = rng.uniform(0, 1, (pts_per_vehicle, 1))
        wall = rng.integers(0, 4, pts_per_vehicle)
        corners = boxes_to_corners_3d_np(v[None], "hwl")[0]
        a, b = corners[wall], corners[(wall + 1) % 4]
        xyz = a + (b - a) * t
        xyz[:, 2] += rng.uniform(0, v[3], pts_per_vehicle)
        walls.append(xyz)
    pts = project_points(np.concatenate(walls), world_to_agent)
    lo, hi = np.array(LIDAR_RANGE[:3]), np.array(LIDAR_RANGE[3:])
    pts = pts[np.all((pts > lo) & (pts < hi), axis=1)][:max_points]
    n_ground = max_points - len(pts)
    ground = np.stack([rng.uniform(lo[0], hi[0], n_ground),
                       rng.uniform(lo[1], hi[1], n_ground),
                       rng.uniform(-1.9 - 0.1, -1.9 + 0.1, n_ground)], 1)
    out = np.zeros((max_points, 4), np.float32)
    out[:, :3] = np.concatenate([pts, ground])[rng.permutation(max_points)]
    out[:, 3] = rng.uniform(0, 1, max_points)
    return out


def vehicles_in_agent_frame(vehicles, pose, limit_range):
    """World hwl boxes -> the agent's frame, those inside the range."""
    world_to_agent = np.linalg.inv(pose_to_world(pose))
    out = vehicles.copy()
    out[:, :3] = project_points(vehicles[:, :3], world_to_agent)
    out[:, 6] = vehicles[:, 6] - np.radians(pose[4])
    return out[mask_boxes_outside_range_np(out, limit_range, "hwl",
                                           min_num_corners=1)]


def camera_rig(traffic: dict) -> tuple[np.ndarray, np.ndarray]:
    """((num_cams, 3, 3) intrinsics, (num_cams, 4, 4) camera -> lidar
    extrinsics) of the traffic's rig, its first ``num_cams`` cameras."""
    n, size = traffic["num_cams"], traffic["image_size"]
    w, h = traffic["camera_image_wh"]
    f = w / (2 * np.tan(np.radians(traffic["camera_fov_deg"]) / 2))
    sx, sy = size / w, size / h
    intrinsic = np.array([[f * sx, 0, size / 2], [0, f * sy, size / 2],
                          [0, 0, 1]])
    lidar = np.asarray(traffic["lidar_mount"], np.float64)
    extrinsics = []
    for x, y, z, yaw in traffic["camera_mounts"][:n]:
        extrinsics.append(pose_to_world(
            [x - lidar[0], y - lidar[1], z - lidar[2], 0.0, yaw, 0.0]))
    return (np.tile(intrinsic, (n, 1, 1)).astype(np.float32),
            np.stack(extrinsics).astype(np.float32))


def make_request(rng, traffic: dict) -> dict:
    """One request of batch 1 (numpy, the port's keys and shapes):
    ``traffic["modes"]`` gives each agent's modality (0 camera, 1 lidar)
    in the first slots of ``traffic["slots"]``; empty slots are lidar
    with no agent, as the port pads them."""
    modes = list(traffic["modes"])
    slots, n = traffic["slots"], len(modes)
    size, cams_n = traffic["image_size"], traffic["num_cams"]
    max_points = traffic["max_points"]
    vehicles, poses = make_scene(rng, n, traffic["vehicles"],
                                 traffic["vehicle_area_m"],
                                 traffic["comm_range_m"])
    mode = np.ones(slots, np.int32)
    mode[:n] = modes
    points = np.zeros((slots, max_points, 4), np.float32)
    points_mask = np.zeros((slots, max_points), np.float32)
    cams = np.zeros((slots, cams_n, size, size, 3), np.float32)
    intrinsics = np.tile(np.eye(3, dtype=np.float32), (slots, cams_n, 1, 1))
    extrinsics = np.tile(np.eye(4, dtype=np.float32), (slots, cams_n, 1, 1))
    rig_intrinsics, rig_extrinsics = camera_rig(traffic)
    agent_mask = np.zeros(slots, np.float32)
    pairwise = np.tile(np.eye(4, dtype=np.float32), (slots, slots, 1, 1))
    to_ego = np.tile(np.eye(4, dtype=np.float32), (slots, 1, 1))
    mats = [pose_to_world(p) for p in poses]
    for i in range(n):
        for j in range(n):
            pairwise[i, j] = np.linalg.inv(mats[j]) @ mats[i]
    for i, pose in enumerate(poses):
        agent_mask[i] = 1
        to_ego[i] = np.linalg.inv(mats[0]) @ mats[i]
        if mode[i] == 1:
            points[i] = lidar_cloud(rng, vehicles, pose, max_points,
                                    traffic["points_per_vehicle"])
            points_mask[i] = 1
        else:
            cams[i] = rng.random(cams[i].shape, dtype=np.float32)
        intrinsics[i] = rig_intrinsics
        extrinsics[i] = rig_extrinsics
    prior = np.zeros((slots, 3), np.float32)
    prior[:n, 0] = rng.uniform(0, 1, n)
    prior[1:n, 1] = rng.integers(0, 3, max(n - 1, 0))
    gt = vehicles_in_agent_frame(vehicles, poses[0], LIDAR_RANGE)
    max_objects = traffic.get("max_objects", 100)
    gt_padded = np.zeros((max_objects, 7), np.float32)
    gt_mask = np.zeros(max_objects, np.float32)
    k = min(len(gt), max_objects)
    gt_padded[:k] = gt[:k]
    gt_mask[:k] = 1
    frame = {"points": points, "points_mask": points_mask, "camera": cams,
             "intrinsics": intrinsics, "extrinsics": extrinsics,
             "mode": mode, "agent_mask": agent_mask,
             "prior_encoding": prior, "pairwise_t_matrix": pairwise,
             "transformation_matrix": to_ego,
             "object_bbx_center": gt_padded, "object_bbx_mask": gt_mask,
             "record_len": np.int32(n)}
    return {k: np.asarray(v)[None] for k, v in frame.items()}


def make_pool(seed: int, traffic: dict) -> list[dict]:
    """The cell's pool of ``traffic["pool"]`` distinct requests."""
    return [make_request(np.random.default_rng([int(seed), i]), traffic)
            for i in range(traffic["pool"])]
