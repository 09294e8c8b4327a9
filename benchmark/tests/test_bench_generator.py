"""The traffic generator: shapes, the filled point slots, the 70 m
poses, the camera rig, and the same requests from the same seed."""
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import generator

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"


def traffic(name="mixed_serve", **changes):
    t = json.loads((TRAFFIC / f"{name}.json").read_text())
    t.update(image_size=16, pool=2, **changes)
    return t


def test_shapes_and_modes():
    t = traffic()
    req = generator.make_pool(7, t)[0]
    slots, mp = t["slots"], t["max_points"]
    assert req["points"].shape == (1, slots, mp, 4)
    assert req["camera"].shape == (1, slots, t["num_cams"], 16, 16, 3)
    assert req["pairwise_t_matrix"].shape == (1, slots, slots, 4, 4)
    assert req["mode"][0].tolist() == t["modes"] + [1] * (slots - 4)
    assert req["agent_mask"][0].tolist() == [1, 1, 1, 1, 0]
    for i, m in enumerate(t["modes"]):
        # a lidar agent has points and no images, a camera agent the other
        assert (req["points_mask"][0, i].sum() > 0) == (m == 1)
        assert (np.abs(req["camera"][0, i]).sum() > 0) == (m == 0)


@pytest.mark.parametrize("name", ["mixed_serve", "mixed_train"])
def test_every_point_slot_filled_inside_the_range(name):
    t = traffic(name)
    assert t["max_points"] == 60000
    req = generator.make_pool(11, t)[1]
    lo, hi = np.array(generator.LIDAR_RANGE[:3]), \
        np.array(generator.LIDAR_RANGE[3:])
    for i, m in enumerate(t["modes"]):
        if m != 1:
            continue
        assert req["points_mask"][0, i].sum() == 60000
        xyz = req["points"][0, i, :, :3]
        assert np.all((xyz > lo) & (xyz < hi))


def test_agents_within_the_communication_range():
    t = traffic()
    for req in generator.make_pool(3, dict(t, pool=8)):
        d = np.linalg.norm(req["transformation_matrix"][0, :4, :2, 3], axis=1)
        assert d.max() <= t["comm_range_m"]
        assert d[0] < 1e-4


def test_same_seed_same_requests_large_seeds():
    t = traffic()
    seed = 2 ** 31 + 12345
    a, b = generator.make_pool(seed, t), generator.make_pool(seed, t)
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    c = generator.make_pool(seed + 1, t)
    assert not np.array_equal(a[0]["points"], c[0]["points"])
    # the pool's requests are distinct
    assert not np.array_equal(a[0]["pairwise_t_matrix"],
                              a[1]["pairwise_t_matrix"])


def test_camera_rig_looks_front_right_left_rear():
    """Each camera sees the ground point 10 m out along its own yaw
    (front, right, left, rear: OPV2V's rig), at its image's centre
    column, below the horizon, and no other camera sees it."""
    t = traffic()
    req = generator.make_pool(5, t)[0]
    size = t["image_size"]
    intr, ext = req["intrinsics"][0, 1], req["extrinsics"][0, 1]
    cv = np.array([[0, 1, 0], [0, 0, -1], [1, 0, 0]], np.float64)
    for cam, (x, y, z, yaw) in enumerate(t["camera_mounts"]):
        lx, ly, lz = np.asarray(t["lidar_mount"])
        ground = np.array([x - lx + 10 * np.cos(np.radians(yaw)),
                           y - ly + 10 * np.sin(np.radians(yaw)), -lz, 1])
        for other in range(t["num_cams"]):
            p = cv @ (np.linalg.inv(ext[other]) @ ground)[:3]
            u, v = (intr[other] @ p)[:2] / p[2]
            seen = p[2] > 0 and 0 <= u < size and 0 <= v < size
            assert seen == (other == cam), (cam, other, u, v)
            if other == cam:
                assert abs(u - size / 2) < 1e-3 and v > size / 2
    # a lidar agent carries the same rig
    np.testing.assert_array_equal(req["extrinsics"][0, 0], ext)
