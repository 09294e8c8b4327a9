"""The port's data path against the JAX package's: the mini-OPV2V fixture
writer (the same scene, yaml content, point clouds and camera pixels for
the same arguments and seed), the file codecs (PNG and the YAML subset,
against OpenCV and PyYAML on the JAX fixture's files and on crafted
ones), and ``HeteroCooperativeDataset``: every array of every frame, the
collated batch and the object ids equal in evaluation mode (also with
delayed agents and pose noise), and in training mode (shuffled clouds)
the same arrays with the points equal as sets.  A subprocess shows the
data path loads no PyYAML, OpenCV, Pillow or JAX."""
import glob
import os
import struct
import subprocess
import sys
import zlib

import cv2
import numpy as np
import pytest
import yaml

from hmvit_tpu.data import opv2v as jopv2v
from hmvit_tpu.data.fixture import write_mini_opv2v as jwrite
from hmvit_tpu_torch.data import codecs, opv2v
from hmvit_tpu_torch.data.fixture import write_mini_opv2v
from hmvit_tpu_torch.data.pcd_io import read_pcd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = dict(num_cavs=2, num_frames=3, image_size=64, max_points=512,
               seed=3, min_separation=4.0, area=20.0)
RANGE = [-25.6, -25.6, -3.0, 25.6, 25.6, 1.0]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX fixture root, port fixture root) of the same arguments."""
    jroot = str(tmp_path_factory.mktemp("jax_fixture"))
    proot = str(tmp_path_factory.mktemp("port_fixture"))
    jwrite(jroot, **FIXTURE)
    write_mini_opv2v(proot, **FIXTURE)
    return jroot, proot


def files(root, suffix):
    return sorted(glob.glob(os.path.join(root, "**", "*" + suffix),
                            recursive=True))


def params(root, **extra):
    return dict({
        "train_params": {"max_cav": 5},
        "camera_to_lidar_ratio": 0.5,
        "ego_mode": "lidar",
        "preprocess": {"cav_lidar_range": RANGE, "args": {
            "camera_preprocess": {"args": {"resize_x": 64,
                                           "resize_y": 64}}}},
        "postprocess": {"max_num": 100, "order": "hwl"},
        "root_dir": root, "validate_dir": root,
    }, **extra)


def test_fixture_equals_jax_writer(roots):
    """Parsed yaml equal, the pcd files equal byte for byte (so their
    points), the camera PNGs' and the four BEV map rasters' pixels equal
    as OpenCV reads them."""
    jroot, proot = roots
    rel = {os.path.relpath(f, proot) for f in files(proot, "")
           if os.path.isfile(f)}
    want = {os.path.relpath(f, jroot) for f in files(jroot, "")
            if os.path.isfile(f)}
    assert rel == want and len(rel) == 2 * 3 * 10
    assert sum("_bev_" in name for name in rel) == 2 * 3 * 4
    for name in sorted(rel):
        a, b = os.path.join(jroot, name), os.path.join(proot, name)
        if name.endswith(".yaml"):
            assert jopv2v.load_frame_yaml(b) == jopv2v.load_frame_yaml(a)
        elif name.endswith(".pcd"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()
            assert np.array_equal(read_pcd(b), read_pcd(a))
        else:
            assert np.array_equal(cv2.imread(b), cv2.imread(a)), name


def test_codecs_read_the_jax_fixture_like_pyyaml_and_opencv(roots):
    jroot, _ = roots
    for f in files(jroot, ".yaml"):
        with open(f) as fh:
            text = fh.read()
        want = jopv2v.load_frame_yaml(f)
        assert codecs.yaml_load(text) == want
        # the writer gives what safe_dump gives, byte for byte
        assert codecs.yaml_dump(want) == yaml.safe_dump(want) == text
    for f in files(jroot, ".png"):
        want = cv2.imread(f, cv2.IMREAD_UNCHANGED)
        want = want[..., ::-1] if want.ndim == 3 else want[..., None]
        assert np.array_equal(codecs.read_png(f), want), f


def _png(path, rows, filters, channels):
    """A PNG whose row y is written with filter ``filters[y]``."""
    h, stride = rows.shape
    bpp = channels
    raw = bytearray()
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        cur = rows[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        kind = filters[y]
        if kind == 0:
            pred = np.zeros_like(cur)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, upleft))
        raw.append(kind)
        raw += ((cur - pred) % 256).astype(np.uint8).tobytes()
        prev = cur
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[channels]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
            ">IIBBBBB", stride // channels, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reads_all_five_row_filters(tmp_path, channels):
    """Rows written with None, Sub, Up, Average and Paeth in turn decode
    to the image, as OpenCV decodes them too."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (15, 13, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _png(path, img.reshape(15, -1), [y % 5 for y in range(15)], channels)
    got = codecs.read_png(path)
    assert got.dtype == np.uint8 and np.array_equal(got, img)
    cv = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    cv = cv[..., None] if cv.ndim == 2 else cv
    # OpenCV: grey + alpha as BGRA, RGB(A) as BGR(A)
    order = {1: [0], 2: [0, 0, 0, 1], 3: [2, 1, 0],
             4: [2, 1, 0, 3]}[channels]
    assert np.array_equal(cv, img[..., order])


def test_png_writer_is_read_by_opencv_and_refuses_what_it_cannot(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (21, 34, 3), dtype=np.uint8)
    codecs.write_png(str(tmp_path / "rgb.png"), rgb)
    assert np.array_equal(cv2.imread(str(tmp_path / "rgb.png"))[..., ::-1],
                          rgb)
    codecs.write_png(str(tmp_path / "g.png"), rgb[..., 0])
    assert np.array_equal(cv2.imread(str(tmp_path / "g.png"),
                                     cv2.IMREAD_UNCHANGED), rgb[..., 0])
    assert np.array_equal(codecs.read_png(str(tmp_path / "rgb.png")), rgb)
    cv2.imwrite(str(tmp_path / "deep.png"), rgb.astype(np.uint16) * 257)
    with pytest.raises(ValueError, match="8-bit"):
        codecs.read_png(str(tmp_path / "deep.png"))
    with pytest.raises(ValueError):
        codecs.write_png(str(tmp_path / "x.png"), rgb.astype(np.float32))


@pytest.mark.parametrize("shape,size", [((64, 64), 48), ((40, 56), 64),
                                        ((33, 33), 33), ((96, 80), 31)])
def test_resize_within_one_grey_level_of_opencv(shape, size):
    """cv2's uint8 INTER_LINEAR uses 11-bit fixed-point weights: the
    float64 resize lies within one grey level of it; a same-size resize
    is the image itself."""
    rng = np.random.default_rng(size)
    img = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    got = codecs.resize_bilinear(img, size)
    want = cv2.resize(img, (size, size))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want).max()) <= 1
    if shape == (size, size):
        assert got is img


def test_preprocess_image_within_one_grey_level_of_jax(roots):
    jroot, _ = roots
    path = files(jroot, "_camera0.png")[0]
    mean, std = opv2v.IMAGE_MEAN, opv2v.IMAGE_STD
    for size in (64, 48):
        got = opv2v.preprocess_image(path, size, mean, std)
        want = jopv2v.preprocess_image(path, size, mean, std)
        assert got.shape == want.shape and got.dtype == want.dtype
        # in grey levels; 1e-4 is the float32 rounding of the scaling
        grey = np.abs(got - want) * np.asarray(std) * 255.0
        if size == 64:  # the written size: no resize, the same bits
            assert np.array_equal(got, want)
        assert grey.max() <= 1 + 1e-4


YAML_DOCS = [
    "a: [1, 2.5, 'x', \"y\\tz\", [3, 4]]   # trailing comment\n"
    "b: {k: 1, 'm n': [1, 2]}\n",
    "c: !!python/tuple\n- 1\n- 2\nd: !!python/tuple [3, 4]\n",
    "e: 1e5\nf: .5\ng: -.5\nh: 1.\ni: ~\nj:\nk: 'it''s, fine'\nm: Yes\n"
    "n: off\no: 1.0e16\np: -.inf\nq: 0\nr: +7\n",
    "l:\n  - 1\n  - - 2\n    - 3\n  - x: 1\n    y: [1]\n100: int key\n",
    "---\n# a document start and comments\nlist:\n- a b\n- 'c: d'\n",
]


@pytest.mark.parametrize("doc", YAML_DOCS)
def test_yaml_subset_reads_as_pyyaml_does(doc):
    assert codecs.yaml_load(doc) == yaml.load(doc,
                                              Loader=jopv2v._FrameLoader)


@pytest.mark.parametrize("doc", [
    "a: &x 1", "a: *x", "a: !!str 1", "a: |\n  x", "a: >\n  x", "a: 0x1F",
    "a: 017", "a: 1_000", "a: 1:30", "a: 2001-12-14", "a: b\n  c",
    "a: [1,\n 2]", "a: 1\n---\nb: 2", "a: 1\na: 2", "a:\n\tb: 1",
    "a: [1, 2", "a: @x", "a: \"\\q\""])
def test_yaml_subset_refuses_what_it_does_not_read(doc):
    with pytest.raises(codecs.YamlSubsetError):
        codecs.yaml_load(doc)


def test_yaml_writer_round_trips_through_pyyaml():
    doc = {"b": None, "c": True, "d": 1e-20,
           "e": float("inf"), "f": "x y", "g": [], "h": {}, "i": 1e16,
           "j": "123", "k": -0.0, "l": "yes", "m": [[1, 2], [3, [4, 5]]],
           "n": [{"x": 1, "y": [1, 2]}, {"z": None}], "o": "it's",
           "p": "a: b", 3: "int key", "q": -float("inf"), "r": 1e5}
    text = codecs.yaml_dump(doc)
    assert yaml.load(text, Loader=jopv2v._FrameLoader) == doc
    assert codecs.yaml_load(text) == doc


def assert_frames_equal(got, want, points_as_sets=False):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if key == "object_ids":
            assert g == w
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, key
        if points_as_sets and key == "points":
            for gs, ws, mask in zip(g.reshape(-1, *g.shape[-2:]),
                                    w.reshape(-1, *w.shape[-2:]),
                                    want["points_mask"].reshape(
                                        -1, g.shape[-2])):
                a = gs[mask > 0]
                b = ws[mask > 0]
                assert np.array_equal(a[np.lexsort(a.T[::-1])],
                                      b[np.lexsort(b.T[::-1])])
        else:
            assert np.array_equal(g, w), key


WILD = {
    "plain": {},
    "async": {"wild_setting": {"async": True, "async_overhead": 1}},
    "async_real": {"wild_setting": {"async": True, "async_mode": "real",
                                    "data_size": 2.0,
                                    "transmission_speed": 27.0}},
    "loc_err": {"wild_setting": {"loc_err": True, "xyz_std": 0.5,
                                 "ryp_std": 1.0}},
    "delayed_ego": {"wild_setting": {"async": True, "async_overhead": 1,
                                     "loc_err": True},
                    "cur_ego_pose_flag": False},
}


@pytest.mark.parametrize("wild", list(WILD))
def test_dataset_eval_mode_equals_jax(roots, wild):
    """train=False: every array of every frame, the collated batch and
    the object ids equal (the evaluation draws are seeded with 0 in both
    packages)."""
    jroot, _ = roots
    p = params(jroot, **WILD[wild])
    ours = opv2v.HeteroCooperativeDataset(p, train=False, max_points=600)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=False, max_points=600)
    assert len(ours) == len(theirs) == 3
    assert ours.async_frames == theirs.async_frames
    frames = []
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert_frames_equal(got, want)
        frames.append((got, want))
    if wild == "plain":
        assert any(len(w["object_ids"]) for _, w in frames)
        assert_frames_equal(
            ours.collate_batch([g for g, _ in frames]),
            theirs.collate_batch([w for _, w in frames]))


def test_dataset_train_mode_equals_jax_up_to_point_order(roots):
    """train=True shuffles each cloud (the JAX package through its native
    parser's own generator where that library loads, the port through
    numpy): the same keys, shapes and arrays, the points equal as sets.
    The JAX dataset draws from fresh entropy, so it is re-seeded here as
    the port's ``seed`` seeds it."""
    jroot, _ = roots
    p = params(jroot)
    ours = opv2v.HeteroCooperativeDataset(p, train=True, max_points=600,
                                          seed=11)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=True, max_points=600)
    theirs._rng = np.random.default_rng(11)
    theirs.reinitialize()
    for a, b in zip(ours.modalities, theirs.modalities):
        assert np.array_equal(a, b)
    for i in range(len(ours)):
        assert_frames_equal(ours[i], theirs[i], points_as_sets=True)


def test_dataset_refuses_bev_maps_until_ported(roots):
    """The BEV map ground truth (``add_data_extension``) is ported: each
    eval frame's ``gt_dynamic``, ``gt_static`` and ``has_map_gt`` equal
    the JAX dataset's bit for bit, and every other array too."""
    p = params(roots[0], add_data_extension=["bev_dynamic.png"])
    ours = opv2v.HeteroCooperativeDataset(p, train=False, max_points=600)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=False, max_points=600)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert {"gt_dynamic", "gt_static", "has_map_gt"} <= set(got)
        assert got["has_map_gt"] == 1.0 and got["gt_dynamic"].any()
        assert_frames_equal(got, want)


def test_data_path_loads_no_yaml_opencv_pillow_or_jax(tmp_path):
    """Write a fixture and load, collate and label a frame in a fresh
    interpreter: no PyYAML, OpenCV, Pillow, JAX or JAX package module is
    ever loaded."""
    code = (
        "import sys\n"
        "from hmvit_tpu_torch import prod_overfit as g\n"
        "from hmvit_tpu_torch.postprocess import AnchorPostprocessor\n"
        "import torch\n"
        f"root = {str(tmp_path)!r}\n"
        "g.write_fixture(root, 64, 2, 32, 512)\n"
        "cfg, rng = g.gate_config(64)\n"
        "args = g.parse_args(['--grid', '64', '--image_size', '32',\n"
        "                     '--num_cavs', '2', '--max_points', '512'])\n"
        "pp = AnchorPostprocessor(g.postprocess_config(64, rng))\n"
        "b, lab, gt, ms = g.load_gate_data(args, rng, pp,\n"
        "    pp.generate_anchor_box(), torch.device('cpu'))\n"
        "assert len(b) == 2 and b[0]['camera'].shape[-2] == 32\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('yaml', 'cv2', 'PIL', 'jax', 'flax', 'hmvit_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr
