"""Port parity for the host side of the serving path: the torch anchor
decode and box geometry against the JAX package's numpy functions; the
serving configuration, hints and device batch; and the port's own
copies of the JAX package's numpy helpers (synthetic batches, anchor
grid, pose math, constants, production configuration), each held equal
to its original — the port imports none of them, which a subprocess
checks."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
import hmvit_tpu
import hmvit_tpu_torch
from hmvit_tpu.data import anchors as janchors
from hmvit_tpu.data import synthetic as jsynthetic
from hmvit_tpu.utils import boxes as jboxes
from hmvit_tpu.utils import transforms as jtransforms
from hmvit_tpu_torch import serving, tracing
from hmvit_tpu_torch.data import anchors, synthetic
from hmvit_tpu_torch.utils import boxes, transforms
from tiny_cfg import ANCHOR_ARGS, RANGE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_decode_deltas_matches_jax_package():
    """float32, 1e-5 absolute (exp and sqrt of the same inputs)."""
    rng = np.random.default_rng(1)
    grid = janchors.generate_anchor_grid(ANCHOR_ARGS, "hwl").astype(
        np.float32)
    h, w, a, _ = grid.shape
    deltas = (0.3 * rng.standard_normal((1, 7 * a, h, w))).astype(np.float32)
    want = janchors.decode_deltas(deltas, grid)
    got = anchors.decode_deltas(torch.from_numpy(deltas),
                                torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("order", ["hwl", "lwh"])
def test_box_corners_match_jax_package(order):
    """float32 corners and the sanity / range masks, 1e-5 absolute."""
    rng = np.random.default_rng(2)
    b = np.concatenate([rng.uniform(-60, 60, (9, 2)),
                        rng.uniform(-2, 0.5, (9, 1)),
                        rng.uniform(0.5, 7.0, (9, 3)),
                        rng.uniform(-np.pi, np.pi, (9, 1))], 1).astype(
        np.float32)
    want = jboxes.boxes_to_corners_3d(b, order)
    got = boxes.boxes_to_corners_3d(torch.from_numpy(b), order)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    cw = want.astype(np.float32)
    ct = torch.from_numpy(cw)
    np.testing.assert_array_equal(boxes.sane_size_mask(ct).numpy(),
                                  jboxes.sane_size_mask(cw))
    np.testing.assert_array_equal(boxes.sane_z_mask(ct).numpy(),
                                  jboxes.sane_z_mask(cw))
    rng_lim = [-40.0, -40.0, -3.0, 40.0, 40.0, 1.0]
    np.testing.assert_array_equal(
        boxes.mask_corners_in_range(ct, rng_lim).numpy(),
        jboxes.mask_corners_in_range(cw, rng_lim))


def test_bench_entry_constants_equal_bench():
    """The port's benchmark entry keeps its own copies of bench.py's
    assumed reference rate and metric name, and a peak table of the same
    shape ((device-name prefix, dense bf16 FLOP/s) pairs, looked up by
    prefix)."""
    from hmvit_tpu_torch import bench as pbench

    assert pbench.ASSUMED_REFERENCE_FPS == bench.ASSUMED_REFERENCE_FPS
    assert pbench.METRIC == ("frames/sec/chip 4-agent mixed-modality BEV "
                             "inference")
    assert bench.main.__code__.co_consts.count(pbench.METRIC) == 1
    for table in (pbench.PEAK_BF16_FLOPS, bench.PEAK_BF16_FLOPS):
        assert isinstance(table, tuple) and all(
            isinstance(name, str) and isinstance(peak, float)
            for name, peak in table)
    for name, peak in pbench.PEAK_BF16_FLOPS:
        assert pbench.peak_bf16_flops(name + " (any suffix)") == peak


def test_production_config_equals_bench():
    """The port's PROD_CFG is bench.py's; the serving variants are it
    with only the compute dtypes (and the asked-for kernel routes) set,
    and leave PROD_CFG itself alone."""
    assert serving.PROD_CFG == bench.PROD_CFG
    assert serving.PROD_RANGE == bench.PROD_RANGE
    assert hmvit_tpu_torch.GT_RANGE == hmvit_tpu.GT_RANGE
    ours = repr(serving.PROD_CFG)
    routed = serving.serving_config(serving.PROD_CFG, bf16=True,
                                    fused_wa=True, stripe=False)
    blk = routed["hetero_fusion"]["hetero_fusion_block"]
    assert blk.pop("use_fused_wa") is True
    assert blk.pop("use_stripe") is False
    assert routed == serving.serving_config(serving.PROD_CFG, bf16=True)
    assert repr(serving.PROD_CFG) == ours
    before = repr(bench.PROD_CFG)
    bf16 = serving.serving_config(bench.PROD_CFG, bf16=True)
    assert bf16["lidar"].pop("compute_dtype") == "bfloat16"
    assert bf16["hetero_decoder"].pop("compute_dtype") == "bfloat16"
    assert bf16 == bench.PROD_CFG
    fp32 = serving.serving_config(bench.PROD_CFG, bf16=False)
    blk = fp32["hetero_fusion"]["hetero_fusion_block"]
    assert blk["compute_dtype"] == "float32"
    blk["compute_dtype"] = "bfloat16"
    assert fp32 == bench.PROD_CFG
    assert repr(bench.PROD_CFG) == before


def test_serving_hints_and_bf16_batch():
    modes = np.array([1, 0, 1, 0, 1], np.int32)
    assert serving.serving_hints(modes, 4) == dict(
        camera_bucket=2, active_agents=4, static_ego_modality=1,
        static_modes=(1, 0, 1, 0))
    batch = {"points": np.ones((1, 2, 3, 4), np.float32),
             "camera": np.ones((1, 2, 4, 4, 3), np.float32),
             "mode": modes[None]}
    tb = serving.batch_to_device(batch, torch.device("cpu"), bf16=True)
    assert tb["points"].dtype == torch.float32  # geometry stays float32
    assert tb["camera"].dtype == torch.bfloat16
    assert tb["mode"].dtype == torch.int32


def _rne_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits, rounded to nearest, ties to even (numpy;
    no NaN in ``x``)."""
    u = x.view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)


def _every_high_half(low: int) -> np.ndarray:
    """Every float32 whose low 16 bits are ``low`` and whose exponent is
    not all ones."""
    high = np.arange(1 << 16, dtype=np.uint32)
    high = high[(high >> 7) & 0xFF != 0xFF]
    return ((high << 16) | low).view(np.float32)


def _host_cast_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(26)
    bits = {
        "ties": lambda: _every_high_half(0x8000).view(np.uint32),
        "beside_ties": lambda: np.concatenate(
            [_every_high_half(0x7FFF), _every_high_half(0x8001)]
        ).view(np.uint32),
        "subnormals": lambda: np.concatenate([
            np.array([1, 0x7FFF, 0x8000, 0x8001, 0x18000, 0x7FFFFF],
                     np.uint32),
            rng.integers(1, 0x800000, 100_000, dtype=np.uint32)]) | (
                rng.integers(0, 2, 100_006, dtype=np.uint32) << 31),
        "zeros_and_infs": lambda: np.array(
            [0, 0x80000000, 0x7F800000, 0xFF800000], np.uint32),
        "largest_finite": lambda: np.array(
            [0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x7F7E8000, 0x7F7F0000,
             0xFF7FFFFF, 0xFF7F8000, 0xFF7F7FFF], np.uint32),
        "random_bits": lambda: rng.integers(0, 1 << 32, 1_100_000,
                                            dtype=np.uint32),
        "nan": lambda: np.array(
            [0x7FC00000, 0xFFC00000, 0x7F800001, 0x7FFFFFFF, 0xFF800001,
             0x7F808000, 0x3F800000], np.uint32),
    }[name]()
    return bits.view(np.float32)


@pytest.mark.parametrize("case", ["ties", "beside_ties", "subnormals",
                                  "zeros_and_infs", "largest_finite",
                                  "random_bits", "nan"])
def test_host_cast_rounds_to_nearest_even(case):
    """The bfloat16 server's host cast against numpy's round to nearest
    even, bit for bit; a NaN stays a NaN."""
    x = _host_cast_case(case)
    got = serving._host_cast(x, torch.device("cpu"))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    nan = np.isnan(x)
    assert torch.isnan(got[torch.from_numpy(nan)]).all()
    bits = got.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits[~nan], _rne_bf16_bits(x[~nan]))
    if case == "random_bits":
        assert nan.any() and (~nan).sum() > 1_000_000


def _former_batch_to_device(batch, device, bf16):
    """``batch_to_device`` before the host cast: every array across as it
    is, the cast on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)).to(device)
        if bf16 and t.dtype == torch.float32 and \
                k not in serving.GEOMETRY_KEYS:
            t = t.to(torch.bfloat16)
        out[k] = t
    return out


@pytest.mark.parametrize("bf16", [True, False])
def test_batch_to_device_on_cpu_matches_former(bf16):
    batch, _ = synthetic.make_hetero_batch(
        seed=4, max_cav=5, num_agents=4, max_points=512, image_size=32,
        num_cams=2, lidar_range=RANGE)
    got = serving.batch_to_device(batch, torch.device("cpu"), bf16)
    want = _former_batch_to_device(batch, torch.device("cpu"), bf16)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    assert (got["camera"].dtype == torch.bfloat16) is bf16
    assert got["points"].dtype == torch.float32


@pytest.mark.parametrize("bf16", [True, False])
def test_request_span_counts_cast_and_pageable_bytes(bf16):
    batch, _ = synthetic.make_hetero_batch(
        seed=5, max_cav=5, num_agents=4, max_points=256, image_size=16,
        num_cams=2, lidar_range=RANGE)
    cast = [k for k, v in batch.items() if bf16 and np.asarray(v).dtype
            == np.float32 and k not in serving.GEOMETRY_KEYS]
    with tracing.on() as tracer:
        serving.batch_to_device(batch, torch.device("cpu"), bf16)
    (span,) = [s for s in tracer.collect()["spans"]
               if s["name"] == "request"]
    counts = span["counts"]
    assert counts.get(tracing.REQUEST_HOST_CAST_BYTES, 0) == sum(
        2 * np.asarray(batch[k]).size for k in cast)
    assert counts[tracing.REQUEST_PAGEABLE_BYTES] == sum(
        np.asarray(v).nbytes for k, v in batch.items() if k not in cast)
    assert ("camera" in cast) is bf16 and "points" not in cast


@pytest.mark.parametrize("kwargs", [
    dict(seed=0, max_cav=5, num_agents=4, max_points=512, image_size=32,
         num_cams=2, lidar_range=RANGE),
    dict(seed=3, batch_size=2, max_cav=3, num_agents=2, max_points=256,
         image_size=16, num_cams=1, ego_mode="camera"),
    dict(seed=7, max_cav=4, num_agents=4, max_points=128, image_size=16,
         num_cams=1, ego_mode="lidar", camera_ratio=0.2),
])
def test_synthetic_batch_copy_equals_original(kwargs):
    """Same seed, same arguments -> the same batch, array for array."""
    got, got_gt = synthetic.make_hetero_batch(**kwargs)
    want, want_gt = jsynthetic.make_hetero_batch(**kwargs)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    assert len(got_gt) == len(want_gt)
    for a, b in zip(got_gt, want_gt):
        assert np.array_equal(a, b)


def test_scene_with_min_separation_copy_equals_original():
    a = synthetic.make_scene(np.random.default_rng(5), 3, 20, 30.0, 6.0)
    b = jsynthetic.make_scene(np.random.default_rng(5), 3, 20, 30.0, 6.0)
    assert np.array_equal(a[0], b[0]) and a[1] == b[1]


def test_pose_math_copy_equals_original():
    rng = np.random.default_rng(11)
    poses = [list(rng.uniform(-50, 50, 3)) + list(rng.uniform(-180, 180, 3))
             for _ in range(3)]
    for pose in poses:
        assert np.array_equal(transforms.pose_to_world(pose),
                              jtransforms.pose_to_world(pose))
    assert np.array_equal(transforms.pose_to_pose(poses[0], poses[1]),
                          jtransforms.pose_to_pose(poses[0], poses[1]))
    assert np.array_equal(transforms.pairwise_transforms(poses, 5),
                          jtransforms.pairwise_transforms(poses, 5))
    pts = rng.standard_normal((9, 3))
    m = jtransforms.pose_to_world(poses[2])
    assert np.array_equal(transforms.project_points(pts, m),
                          jtransforms.project_points(pts, m))


@pytest.mark.parametrize("order", ["hwl", "lwh"])
def test_numpy_box_copies_equal_originals(order):
    assert np.array_equal(boxes.CORNER_TEMPLATE, jboxes.CORNER_TEMPLATE)
    rng = np.random.default_rng(4)
    b = np.concatenate([rng.uniform(-30, 30, (12, 3)),
                        rng.uniform(0.5, 6.0, (12, 3)),
                        rng.uniform(-np.pi, np.pi, (12, 1))], 1)
    assert np.array_equal(boxes.boxes_to_corners_3d_np(b, order),
                          jboxes.boxes_to_corners_3d(b, order))
    lim = [-20.0, -20.0, -3.0, 20.0, 20.0, 1.0]
    for k in (1, 8):
        assert np.array_equal(
            boxes.mask_boxes_outside_range_np(b, lim, order, k),
            jboxes.mask_boxes_outside_range(b, lim, order, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_points_in_rotated_box_copy_equals_original(seed):
    """The port's copy of ``points_in_rotated_box_mask`` (the seg
    rasterizer's and the PIXOR labels'), bit for bit, with points on the
    edges and corners."""
    rng = np.random.default_rng(40 + seed)
    box = np.concatenate([rng.uniform(-5, 5, 2), [0.0],
                          rng.uniform(1, 5, 3), rng.uniform(-np.pi, np.pi, 1)])
    corners = boxes.boxes_to_corners_3d_np(box[None], "lwh")[0, :4, :2]
    pts = np.concatenate([rng.uniform(-8, 8, (500, 2)), corners,
                          (corners + np.roll(corners, 1, 0)) / 2])
    got = boxes.points_in_rotated_box_mask(pts, corners)
    want = jboxes.points_in_rotated_box_mask(pts, corners)
    assert got.dtype == want.dtype == bool
    assert np.array_equal(got, want) and got.any() and not got.all()


@pytest.mark.parametrize("order", ["hwl", "lhw"])
def test_anchor_grid_copy_equals_original(order):
    prod = {"W": 512, "H": 512, "l": 3.9, "w": 1.6, "h": 1.56,
            "r": [0, 90], "num": 2, "feature_stride": 4, "vw": 0.4,
            "vh": 0.4, "cav_lidar_range": serving.PROD_RANGE}
    for args in (ANCHOR_ARGS, prod):
        got = anchors.generate_anchor_grid(args, order)
        want = janchors.generate_anchor_grid(args, order)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(ValueError):
        anchors.generate_anchor_grid(ANCHOR_ARGS, "xyz")


def test_port_imports_nothing_of_the_jax_package():
    """Importing every module of the port and chip_smoke.py leaves no
    jax, flax, hmvit_tpu or bench module loaded."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import hmvit_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(hmvit_tpu_torch.__path__,"
        " 'hmvit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith(('jax', 'flax')) or m == 'bench'\n"
        "       or m == 'hmvit_tpu' or m.startswith('hmvit_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_box_corner_order_defaults_to_jax_packages():
    """``boxes_to_corners_3d`` defaults to ``lwh``, as the JAX function and
    the port's numpy copies do (ROADMAP Queue 3 P4)."""
    import inspect

    for fn in (boxes.boxes_to_corners_3d, boxes.boxes_to_corners_3d_np,
               boxes.corners_to_boxes, jboxes.boxes_to_corners_3d,
               jboxes.corners_to_boxes):
        assert inspect.signature(fn).parameters["order"].default == "lwh"
    rng = np.random.default_rng(9)
    b = np.concatenate([rng.uniform(-9, 9, (5, 3)), rng.uniform(1, 5, (5, 3)),
                        rng.uniform(-3, 3, (5, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(
        boxes.boxes_to_corners_3d(torch.from_numpy(b)).numpy(),
        jboxes.boxes_to_corners_3d(b), atol=1e-5, rtol=0)


def test_data_constants_equal_originals():
    from hmvit_tpu.data import opv2v as jopv2v
    from hmvit_tpu_torch.data import opv2v

    assert hmvit_tpu_torch.COM_RANGE == hmvit_tpu.COM_RANGE
    ds, jds = opv2v.HeteroCooperativeDataset, jopv2v.HeteroCooperativeDataset
    assert opv2v.IMAGE_MEAN == ds.IMAGE_MEAN == jds.IMAGE_MEAN
    assert opv2v.IMAGE_STD == ds.IMAGE_STD == jds.IMAGE_STD


def _literal(tree, target, names):
    """The value of ``prod_overfit.py``'s assignment to ``target`` inside
    ``main``, evaluated with ``names`` bound."""
    import ast

    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == target)
    return eval(compile(ast.Expression(node.value), "prod_overfit.py",
                        "eval"), {}, names)


@pytest.mark.parametrize("grid", [64, 512])
def test_gate_configuration_equals_prod_overfit_literals(grid, monkeypatch):
    """The port's gate takes the JAX script's configuration: its model
    config, anchors and decode (``anchor_args``, ``pp_cfg``), dataset
    parameters and fixture arguments, read from ``prod_overfit.py``'s own
    source; and ``optax.adamw``'s default weight decay."""
    import argparse
    import ast
    import copy
    import inspect

    import optax

    from hmvit_tpu_torch import prod_overfit as gate

    with open(os.path.join(REPO, "prod_overfit.py")) as f:
        tree = ast.parse(f.read())
    cfg, lidar_range = gate.gate_config(grid)
    half_range = grid * 0.4 / 2.0
    assert lidar_range == [-half_range, -half_range, -3.0, half_range,
                           half_range, 1.0]
    want = copy.deepcopy(bench.PROD_CFG)
    want["lidar"]["lidar_range"] = lidar_range
    want["lidar"]["point_pillar_scatter"]["grid_size"] = [grid, grid, 1]
    want["camera"]["bev_size"] = max(grid // 4, 8)
    want["camera"]["bev_range"] = half_range
    want["remat"] = True
    assert cfg == want
    names = {"grid": grid, "lidar_range": lidar_range, "root": "/r",
             "args": argparse.Namespace(image_size=48)}
    names["anchor_args"] = _literal(tree, "anchor_args", names)
    assert gate.postprocess_config(grid, lidar_range) == \
        _literal(tree, "pp_cfg", names)
    assert gate.dataset_params("/r", lidar_range, 48) == \
        _literal(tree, "params_ds", names)
    seen = {}
    monkeypatch.setattr(gate, "write_mini_opv2v",
                        lambda root, **kw: seen.update(kw))
    gate.write_fixture("/r", grid, 4, 512, 30000)
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "write_mini_opv2v")
    scope = {"args": argparse.Namespace(num_cavs=4, image_size=512,
                                        max_points=30000),
             "half_range": half_range, "min": min}
    assert seen == {k.arg: eval(compile(ast.Expression(k.value), "", "eval"),
                                {}, scope) for k in call.keywords}
    sig = inspect.signature(optax.adamw).parameters
    assert gate.ADAMW == {
        "betas": (sig["b1"].default, sig["b2"].default),
        "eps": sig["eps"].default,
        "weight_decay": sig["weight_decay"].default}
    assert gate.ADAMW["weight_decay"] == 1e-4
