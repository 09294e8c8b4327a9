"""The port's native host helpers against the JAX package's: the rotated
IoU / greedy NMS clipper (``hmvit_tpu_torch/native/rotated_nms.cpp``)
held to the port's numpy loop and to JAX's ``nms_rotated_native``
(``test_native_nms.py``'s four cases), the pcd parser
(``hmvit_tpu_torch/native/pcd_parser.cpp``) held to JAX's native read bit
for bit (binary, ascii and packed-rgb clouds, shuffled and not), the two
sources byte-equal to ``native/``, the backend counters and fallbacks, and
a train-mode frame of the port's dataset equal to JAX's."""
import os
import subprocess
import sys

import numpy as np
import pytest

from hmvit_tpu.data import opv2v as jopv2v
from hmvit_tpu.data.pcd_native import read_pcd_padded as jread
from hmvit_tpu.utils import boxes as jboxes
from hmvit_tpu.utils.nms_native import nms_rotated_native as jnms_native
from hmvit_tpu_torch.data import opv2v, pcd_native
from hmvit_tpu_torch.data.pcd_io import read_pcd_padded as read_pcd_padded_numpy
from hmvit_tpu_torch.data.pcd_io import write_pcd
from hmvit_tpu_torch.ops import host_build
from hmvit_tpu_torch.utils import nms, nms_native
from hmvit_tpu_torch.utils.iou import rotated_iou_matrix_np
from test_data_extras import write_binary_pcd, write_rgb_pcd
from test_torch_opv2v import assert_frames_equal, params, roots  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_corners(rng, n):
    boxes = np.zeros((n, 7))
    boxes[:, 0] = rng.uniform(-30, 30, n)
    boxes[:, 1] = rng.uniform(-30, 30, n)
    boxes[:, 3] = rng.uniform(2.5, 5.0, n)
    boxes[:, 4] = rng.uniform(1.2, 2.2, n)
    boxes[:, 5] = 1.5
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return jboxes.boxes_to_corners_2d(boxes, "lwh")[..., :2]


def jax_native_or_none(corners, scores, threshold, top=1000):
    """JAX's native NMS, or None where its library does not build."""
    return jnms_native(corners, scores, threshold, top)


@pytest.mark.parametrize("name", ["rotated_nms", "pcd_parser"])
def test_native_sources_byte_equal_to_the_jax_package(name):
    with open(os.path.join(REPO, "native", f"{name}.cpp"), "rb") as f:
        want = f.read()
    assert host_build.source(name).read_bytes() == want


def test_native_libraries_build_into_the_package():
    """Both build here (g++), into ``_build`` under a hashed name, never
    into ``native/``."""
    assert nms_native.library(require=True) is not None
    assert pcd_native.library(require=True) is not None
    for name in ("rotated_nms", "pcd_parser"):
        path = host_build.library_path(name, host_build.compiler())
        assert path.exists() and path.parent == host_build.BUILD_DIR
        assert host_build.failure(name) is None


def test_native_iou_matches_numpy():
    """Within 1e-5 of the numpy IoU (both clip in double precision; the
    native one returns float32)."""
    rng = np.random.default_rng(0)
    a = random_corners(rng, 40)
    b = random_corners(rng, 30)
    got = nms_native.rotated_iou_matrix_native(a, b, require=True)
    np.testing.assert_allclose(got, rotated_iou_matrix_np(a, b), atol=1e-5)


def test_native_iou_degenerate_overlaps():
    """Identical, contained, disjoint and touching squares (1e-6)."""
    sq = np.array([[[-1, -1], [1, -1], [1, 1], [-1, 1]]], np.float32)
    a = np.concatenate([sq, sq, sq, sq])
    b = np.concatenate([sq, 0.5 * sq, sq + np.float32([5.0, 0.0]),
                        sq + np.float32([2.0, 0.0])])
    got = np.diag(nms_native.rotated_iou_matrix_native(a, b, require=True))
    np.testing.assert_allclose(got, [1.0, 0.25, 0.0, 0.0], atol=1e-6)


@pytest.mark.parametrize("trial", range(5))
def test_native_nms_pick_order_equals_numpy_and_jax(trial):
    """The same kept indices in the same pick order: the native backend,
    the numpy loop, the default backend and JAX's native NMS."""
    rng = np.random.default_rng(100 + trial)
    n = 120
    corners = random_corners(rng, n)
    # distinct scores: the greedy pick order is then the score order
    scores = rng.permutation(n).astype(np.float32) / n + 0.01
    want = nms.nms_rotated(corners, scores, 0.15, backend="numpy")
    got = nms.nms_rotated(corners, scores, 0.15, backend="native")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(nms.nms_rotated(corners, scores, 0.15),
                                  want)
    theirs = jax_native_or_none(corners, scores, 0.15)
    if theirs is not None:
        np.testing.assert_array_equal(got, theirs)


def test_native_nms_respects_top_cap():
    rng = np.random.default_rng(2)
    corners = random_corners(rng, 50)
    scores = rng.permutation(50).astype(np.float32) + 1.0
    want = nms.nms_rotated(corners, scores, 0.15, top=10, backend="numpy")
    got = nms_native.nms_rotated_native(corners, scores, 0.15, top=10,
                                        require=True)
    np.testing.assert_array_equal(got, want)
    theirs = jax_native_or_none(corners, scores, 0.15, top=10)
    if theirs is not None:
        np.testing.assert_array_equal(got, theirs)


def test_tied_scores_keep_the_same_boxes_on_both_backends():
    """Ties go to the lower index on both backends (bf16 scores tie)."""
    rng = np.random.default_rng(3)
    corners = random_corners(rng, 200)
    scores = rng.integers(0, 8, 200).astype(np.float32) / 8
    want = nms.nms_rotated(corners, scores, 0.15, backend="numpy")
    np.testing.assert_array_equal(
        nms.nms_rotated(corners, scores, 0.15, backend="native"), want)
    order = np.argsort(-scores, kind="stable")
    assert list(want) == [i for i in order if i in set(want)]


def test_backend_counters():
    """``host_build`` counts the calls and seconds each path served, by
    library; an unknown backend is refused by name."""
    rng = np.random.default_rng(4)
    corners = random_corners(rng, 30)
    scores = rng.uniform(size=30).astype(np.float32)
    host_build.reset_counts()
    nms.nms_rotated(corners, scores, 0.15)
    nms.nms_rotated(corners, scores, 0.15, backend="numpy")
    nms.nms_rotated(corners[:0], scores[:0], 0.15, backend="numpy")
    assert host_build.calls("rotated_nms") == {"native": 1, "numpy": 2}
    spent = host_build.seconds("rotated_nms")
    assert spent["native"] > 0 and spent["numpy"] > 0
    assert host_build.calls("pcd_parser") == {"native": 0, "numpy": 0}
    with pytest.raises(ValueError, match="backend"):
        nms.nms_rotated(corners, scores, 0.15, backend="gpu")


def test_failed_build_warns_once_and_the_numpy_path_serves(tmp_path):
    """A compiler that fails: one warning naming the compiler's output,
    the numpy paths serve and are counted, ``backend="native"`` raises."""
    code = f"""
import os, warnings, numpy as np
os.environ["CXX"] = "false"
from hmvit_tpu_torch.ops import host_build
host_build.BUILD_DIR = __import__("pathlib").Path({str(tmp_path)!r})
from hmvit_tpu_torch.utils import nms
from hmvit_tpu_torch.data import pcd_native
from hmvit_tpu_torch.data.pcd_io import read_pcd_padded as read_pcd_padded_numpy
from hmvit_tpu_torch.data.pcd_io import write_pcd
c = np.random.default_rng(0).uniform(-9, 9, (6, 4, 2))
s = np.arange(6, dtype=np.float32)
with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    a = nms.nms_rotated(c, s, 0.1)
    b = nms.nms_rotated(c, s, 0.1)
    write_pcd({str(tmp_path / 'p.pcd')!r}, np.ones((5, 4), np.float32))
    out, mask = pcd_native.read_pcd_padded({str(tmp_path / 'p.pcd')!r}, 8)
msgs = [str(w.message) for w in caught]
assert len(msgs) == 2, msgs
assert all("numpy path serves instead" in m and "false failed" in m
           for m in msgs), msgs
assert host_build.calls("rotated_nms") == {{"native": 0, "numpy": 2}}
assert host_build.calls("pcd_parser") == {{"native": 0, "numpy": 1}}
assert (a == b).all() and mask.sum() == 5
try:
    nms.nms_rotated(c, s, 0.1, backend="native")
except host_build.HostLibraryError as err:
    assert "rotated_nms" in str(err)
else:
    raise AssertionError("backend='native' did not raise")
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, env=dict(os.environ,
                                                       PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def write_ascii_pcd(path, pts):
    write_pcd(path, pts)


WRITERS = {
    "binary": lambda path, pts: write_binary_pcd(path, pts),
    "ascii": write_ascii_pcd,
    "rgb": lambda path, pts: write_rgb_pcd(path, pts[:, :3],
                                           np.abs(pts[:, 3]) % 1.0),
}


@pytest.mark.parametrize("kind", sorted(WRITERS))
@pytest.mark.parametrize("shuffle", [False, True])
def test_native_pcd_read_equals_jax_native_read(tmp_path, kind, shuffle):
    """Bit for bit: the same points in the same order, truncated or not,
    for seeds 0 (the parser's default state) and 7."""
    pts = np.random.default_rng(5).uniform(-50, 50, (700, 4)).astype(
        np.float32)
    path = str(tmp_path / f"{kind}.pcd")
    WRITERS[kind](path, pts)
    host_build.reset_counts()
    for max_points, seed in ((900, 0), (900, 7), (300, 7)):
        got = pcd_native.read_pcd_padded(path, max_points, seed=seed,
                                         shuffle=shuffle)
        want = jread(path, max_points, seed=seed, shuffle=shuffle)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    assert host_build.calls("pcd_parser") == {"native": 3, "numpy": 0}
    # unshuffled, the numpy reader reads the same
    if not shuffle:
        np.testing.assert_array_equal(
            read_pcd_padded_numpy(path, 900)[0],
            pcd_native.read_pcd_padded(path, 900)[0])


def test_pcd_counters_and_refused_file(tmp_path):
    """The reads each path served; a file without x / y / z goes to the
    numpy reader (counted), which names the fault."""
    path = str(tmp_path / "a.pcd")
    write_pcd(path, np.ones((4, 4), np.float32))
    host_build.reset_counts()
    pcd_native.read_pcd_padded(path, 8)
    assert host_build.calls("pcd_parser") == {"native": 1, "numpy": 0}
    bad = str(tmp_path / "bad.pcd")
    with open(bad, "w") as f:
        f.write("FIELDS a b\nSIZE 4 4\nTYPE F F\nPOINTS 1\nDATA ascii\n1 2\n")
    with pytest.raises(KeyError):
        pcd_native.read_pcd_padded(bad, 8)
    assert host_build.calls("pcd_parser") == {"native": 1, "numpy": 1}


def test_dataset_train_mode_equals_jax(roots):  # noqa: F811
    """train=True: each cloud shuffled by the native parser in both
    packages, so every array of every frame is equal, the points in the
    same order (the JAX dataset re-seeded as the port's ``seed`` seeds
    it).  Skipped where JAX's native parser does not build (its dataset
    then shuffles through numpy)."""
    from hmvit_tpu.data import pcd_native as jpcd_native

    if jpcd_native._load() is None:
        pytest.skip("the JAX package's native pcd parser does not build")
    jroot, _ = roots
    p = params(jroot)
    ours = opv2v.HeteroCooperativeDataset(p, train=True, max_points=600,
                                          seed=11)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=True, max_points=600)
    theirs._rng = np.random.default_rng(11)
    theirs.reinitialize()
    host_build.reset_counts()
    for i in range(len(ours)):
        assert_frames_equal(ours[i], theirs[i])
    reads = host_build.calls("pcd_parser")
    assert reads["numpy"] == 0 and reads["native"] > 0
