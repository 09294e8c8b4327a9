"""Port parity for the host side of the serving path: the torch anchor
decode and box geometry against the JAX package's numpy functions, and
the serving configuration, hints and device batch built from bench.py's
production configuration."""
import numpy as np
import pytest
import torch

import bench
from hmvit_tpu.data import anchors as janchors
from hmvit_tpu.utils import boxes as jboxes
from hmvit_tpu_torch import serving
from hmvit_tpu_torch.data import anchors
from hmvit_tpu_torch.utils import boxes
from tiny_cfg import ANCHOR_ARGS


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


def test_production_config_equals_bench():
    """The serving variants are bench.py's PROD_CFG with only the compute
    dtypes set, and leave PROD_CFG itself alone."""
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
