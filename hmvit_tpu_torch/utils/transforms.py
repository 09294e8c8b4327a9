"""Pose / coordinate-frame math (host side, numpy): the port's own copy
of what its synthetic scenes need from ``hmvit_tpu/utils/transforms.py``
(the port shares no code with the JAX package it is tested against).

CARLA pose convention: ``[x, y, z, roll, yaw, pitch]`` with angles in
degrees.
"""
from __future__ import annotations

import numpy as np


def pose_to_world(pose) -> np.ndarray:
    """4x4 homogeneous transform from the pose's local frame to CARLA world.

    The rotation is built from intrinsic yaw (z), pitch (y), roll (x) in the
    UE4 left-handed-compensated form used by CARLA's client API.
    """
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


def pose_to_pose(src_pose, dst_pose) -> np.ndarray:
    """4x4 transform taking coordinates in ``src_pose``'s frame to
    ``dst_pose``'s frame (both poses given in world coordinates)."""
    src_to_world = pose_to_world(src_pose)
    world_to_dst = np.linalg.inv(pose_to_world(dst_pose))
    return world_to_dst @ src_to_world


def pairwise_transforms(poses, max_agents: int) -> np.ndarray:
    """Dense (max_agents, max_agents, 4, 4) matrix of frame transforms.

    ``out[i, j]`` maps agent-i coordinates into agent-j's frame
    (T_j^-1 @ T_i).  Unused slots are identity.
    """
    out = np.tile(np.identity(4), (max_agents, max_agents, 1, 1))
    mats = [pose_to_world(p) for p in poses]
    invs = [np.linalg.inv(m) for m in mats]
    n = len(mats)
    for i in range(n):
        for j in range(n):
            out[i, j] = invs[j] @ mats[i]
    return out


def project_points(points: np.ndarray, transform: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (N, 3) points -> (N, 3)."""
    pts = np.hstack([points[:, :3], np.ones((points.shape[0], 1))])
    return (pts @ transform.T)[:, :3]
