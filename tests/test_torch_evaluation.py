"""The port's host evaluation against the JAX package's: the VOC AP
evaluation (``utils/evaluation.py``: ``voc_ap``, ``accumulate_frame`` in
IoU and distance modes, ``calculate_ap``, ``final_results``) exactly, on
seeded random frames; the numpy rotated IoU exactly; ``corners_to_boxes``
within 1e-12; and the host ``nms_rotated`` with the pick order of the
JAX function's ``backend="numpy"`` loop."""
import numpy as np
import pytest

from hmvit_tpu.utils import boxes as jboxes
from hmvit_tpu.utils import evaluation as jeval
from hmvit_tpu.utils.iou import rotated_iou_matrix as jiou
from hmvit_tpu.utils.nms import nms_rotated as jnms
from hmvit_tpu_torch.utils import boxes, evaluation
from hmvit_tpu_torch.utils.iou import rotated_iou_matrix_np
from hmvit_tpu_torch.utils.nms import nms_rotated


def random_boxes(rng, n, spread=20.0):
    """(n, 7) hwl boxes of car size, many overlapping."""
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1.5, -0.5, (n, 1)),
        rng.uniform(1.4, 1.8, (n, 1)), rng.uniform(1.6, 2.1, (n, 1)),
        rng.uniform(3.6, 5.0, (n, 1)), rng.uniform(-np.pi, np.pi, (n, 1)),
    ], axis=1)


def random_frame(rng, n_gt, n_det):
    """(det corners, det scores, gt corners) of one frame: detections are
    jittered copies of some ground-truth boxes plus strays."""
    gt = random_boxes(rng, n_gt)
    near = gt[rng.integers(0, max(n_gt, 1), n_det)] if n_gt else \
        random_boxes(rng, n_det)
    det = near + rng.normal(0, [0.6, 0.6, 0.1, 0.05, 0.1, 0.3, 0.2],
                            near.shape)
    stray = rng.uniform(size=n_det) < 0.3
    det[stray] = random_boxes(rng, int(stray.sum()))
    scores = rng.uniform(0.2, 1.0, n_det)
    return (jboxes.boxes_to_corners_3d(det, "hwl"), scores,
            jboxes.boxes_to_corners_3d(gt, "hwl"))


@pytest.mark.parametrize("mode", ["iou", "distance", "both"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_evaluation_equals_jax_package(mode, seed):
    """Seeded frames (some without detections, one without ground truth)
    accumulated by both packages: every tp / fp list and gt count, every
    (rec, prec) AP and the final dict equal exactly."""
    rng = np.random.default_rng(seed)
    ours, theirs = evaluation.new_result_stat(mode), jeval.new_result_stat(mode)
    assert ours == theirs
    for f in range(6):
        det, scores, gt = random_frame(rng, int(rng.integers(0, 7)),
                                       int(rng.integers(0, 12)))
        if f == 2:
            det, scores = np.zeros((0, 8, 3)), np.zeros((0,))
        if f == 4:
            gt = None
        evaluation.accumulate_frame(det, scores, gt, ours)
        jeval.accumulate_frame(det, scores, gt, theirs)
    assert ours == theirs
    for key, stat in ours.items():
        for t in stat:
            assert evaluation.calculate_ap(stat, t) == \
                jeval.calculate_ap(theirs[key], t)
    assert evaluation.final_results(ours) == jeval.final_results(theirs)


def test_voc_ap_equals_jax_package():
    rng = np.random.default_rng(5)
    for n in (0, 1, 7, 30):
        rec = np.sort(rng.uniform(size=n)).tolist()
        prec = rng.uniform(size=n).tolist()
        assert evaluation.voc_ap(rec, prec) == jeval.voc_ap(rec, prec)
    assert evaluation.IOU_THRESHOLDS == jeval.IOU_THRESHOLDS
    assert evaluation.DISTANCE_THRESHOLDS == jeval.DISTANCE_THRESHOLDS


def test_rotated_iou_np_equals_jax_package():
    rng = np.random.default_rng(3)
    a = jboxes.boxes_to_corners_3d(random_boxes(rng, 17, 6.0), "hwl")
    b = jboxes.boxes_to_corners_3d(random_boxes(rng, 11, 6.0), "hwl")
    want = np.asarray(jiou(a, b, np))
    got = rotated_iou_matrix_np(a, b)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (want > 0).any()
    assert rotated_iou_matrix_np(a[:0], b).shape == (0, 11)


@pytest.mark.parametrize("order", ["hwl", "lwh"])
def test_corners_to_boxes_equals_jax_package(order):
    """Exact inverse on well-formed boxes, and the least-squares estimate
    on noisy corners, both within 1e-12 of the JAX function."""
    rng = np.random.default_rng(7)
    b = random_boxes(rng, 25)
    corners = jboxes.boxes_to_corners_3d(b, order)
    noisy = corners + rng.normal(0, 0.05, corners.shape)
    for c in (corners, noisy):
        got = boxes.corners_to_boxes(c, order)
        want = jboxes.corners_to_boxes(c, order)
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    np.testing.assert_allclose(boxes.corners_to_boxes(corners, order), b,
                               atol=1e-9)
    with pytest.raises(ValueError):
        boxes.corners_to_boxes(corners, "xyz")


@pytest.mark.parametrize("threshold", [0.0, 0.15, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_host_nms_pick_order_equals_jax_numpy(threshold, seed):
    rng = np.random.default_rng(seed)
    corners = jboxes.boxes_to_corners_3d(random_boxes(rng, 60, 8.0), "hwl")
    scores = rng.uniform(size=60).astype(np.float32)
    want = jnms(corners, scores, threshold, backend="numpy")
    got = nms_rotated(corners, scores, threshold, backend="numpy")
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(
        nms_rotated(corners, scores, threshold, top=10, backend="numpy"),
        jnms(corners, scores, threshold, top=10, backend="numpy"))
    assert nms_rotated(corners[:0], scores[:0], threshold,
                       backend="numpy").shape == (0,)
