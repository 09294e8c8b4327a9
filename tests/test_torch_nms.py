"""The port's device NMS (``hmvit_tpu_torch/utils/nms.py``) against the
JAX package's ``nms_rotated_device`` and against the greedy loop over
live boxes that the port ran before (a host read of the live count
bounded it): seeded sets of 512 candidates with no live box, a few,
more than 256 (``max_keep``), and tied scores.  The kept SETS must be
equal (exactly: the same float32 IoU test on the same boxes).  A guard
that refuses every host read shows the function reads nothing back, so
a CUDA graph can capture it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.utils.nms import nms_rotated_device as jax_nms
from hmvit_tpu_torch.utils.iou import rotated_iou_matrix
from hmvit_tpu_torch.utils.nms import nms_rotated_device
from torch_parity import NoHostReads

K = 512
THRESHOLD = 0.15


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def candidates(seed: int, live: int, ties: bool = False):
    """(corners (K, 4, 2) float32, scores (K,) float32): ``live`` boxes of
    car size in a 40 m square (many overlap), scored in (0.3, 1), the
    rest at score 0; ``ties`` draws the scores from 8 values."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-20.0, 20.0, (K, 2))
    lw = rng.uniform([3.5, 1.5], [4.8, 2.1], (K, 2))
    yaw = rng.uniform(-np.pi, np.pi, K)
    half = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]]) / 2.0
    local = lw[:, None, :] * half[None]
    c, s = np.cos(yaw)[:, None], np.sin(yaw)[:, None]
    corners = np.stack([local[..., 0] * c - local[..., 1] * s,
                        local[..., 0] * s + local[..., 1] * c], -1)
    corners = (corners + xy[:, None, :]).astype(np.float32)
    if ties:
        scores = rng.choice(np.linspace(0.3, 1.0, 8), K)
    else:
        scores = rng.uniform(0.3, 1.0, K)
    scores[live:] = 0.0
    return corners, rng.permutation(scores).astype(np.float32)


def loop_over_live(corners, scores, threshold, max_keep=256):
    """The port's previous form: the greedy loop bounded by the live
    count read back to the host."""
    k = corners.shape[0]
    order = torch.argsort(-scores, stable=True)
    sc = corners[order]
    suppress_next = rotated_iou_matrix(sc, sc) > threshold
    alive = scores[order] > 0
    later = torch.arange(k)
    for i in range(min(int(alive.sum()), max_keep)):
        alive = alive & ~(suppress_next[i] & (later > i) & alive[i])
    keep = torch.zeros(k, dtype=torch.bool)
    keep[order] = alive
    return keep


CASES = [("none", 0, False), ("few", 12, False), ("many", 400, False),
         ("all", K, False), ("ties", 300, True)]


@pytest.mark.parametrize("name,live,ties", CASES, ids=[c[0] for c in CASES])
def test_keeps_the_jax_set(name, live, ties):
    corners, scores = candidates(len(name) * 7 + live, live, ties)
    keep, order = nms_rotated_device(torch.from_numpy(corners),
                                     torch.from_numpy(scores), THRESHOLD)
    jkeep, _ = jax_nms(jnp.asarray(corners), jnp.asarray(scores), THRESHOLD)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(
        keep.numpy(), loop_over_live(torch.from_numpy(corners),
                                     torch.from_numpy(scores),
                                     THRESHOLD).numpy())
    assert sorted(order.tolist()) == list(range(K))
    kept = int(keep.sum())
    if live == 0:
        assert kept == 0
    else:
        assert 0 < kept < live  # something suppressed, something kept
    if live > 256:
        # ranks past max_keep suppress nothing but can still be kept
        ranks = torch.empty(K, dtype=torch.long)
        ranks[order] = torch.arange(K)
        assert bool((ranks[keep] >= 256).any())


def test_makes_no_host_read():
    corners, scores = candidates(3, 300)
    c, s = torch.from_numpy(corners), torch.from_numpy(scores)
    want, _ = nms_rotated_device(c, s, THRESHOLD)
    with NoHostReads():
        keep, _ = nms_rotated_device(c, s, THRESHOLD)
    assert torch.equal(keep, want)
    with pytest.raises(AssertionError, match="host read"), NoHostReads():
        loop_over_live(c, s, THRESHOLD)
