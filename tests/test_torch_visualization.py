"""The port's visualization against the JAX package's (``test_aux.py``'s
and ``test_opv2v_loader.py``'s visualization cases): the 3D HTML viewer
byte-equal, the camera projection at 1e-6, ``draw_2d_boxes`` pixel-equal
to OpenCV's rectangles, ``draw_3d_boxes`` within a pixel of OpenCV's
anti-aliased lines, ``get_sample`` equal, ``merge_maps`` pixel-equal (and
within one grey level after a resize), and the numpy BEV raster: its
shape and the pixels at each point's and ring edge's position."""
import os
import sys

import cv2
import numpy as np
import pytest
from scipy.ndimage import binary_dilation

from hmvit_tpu.data import opv2v as jopv2v
from hmvit_tpu.utils import boxes as jboxes
from hmvit_tpu.utils import camera as jcamera
from hmvit_tpu.visualization import merge_maps as jmerge
from hmvit_tpu.visualization import viewer3d as jviewer3d
from hmvit_tpu_torch.data import codecs, opv2v
from hmvit_tpu_torch.utils import camera
from hmvit_tpu_torch.utils.boxes import boxes_to_corners_3d_np
from hmvit_tpu_torch.visualization import merge_maps, sequence, vis, \
    vis_npy, viewer3d
from test_torch_opv2v import params, roots  # noqa: F401

# the camera of test_aux.py::test_camera_box_drawing: 1.5 m up, looking
# along +x, f = 64 on a 128^2 image
F, S = 64.0, 128
INTRINSIC = np.array([[F, 0, S / 2], [0, F, S / 2], [0, 0, 1.0]])
CAM_POSE = np.eye(4)
CAM_POSE[2, 3] = 1.5
BOXES = np.array([[8.0, 0.0, 0.0, 1.6, 1.8, 4.2, 0.3],
                  [12.0, -3.0, 0.0, 1.5, 2.0, 4.5, -0.7],
                  [20.0, 4.0, 0.5, 1.5, 1.9, 4.0, 1.2],
                  [-8.0, 0.0, 0.0, 1.6, 1.8, 4.2, 0.0]])  # behind


def within_a_pixel(a, b) -> bool:
    """Every pixel one mask sets lies within one pixel (8-neighbourhood)
    of a pixel the other sets, both ways."""
    k = np.ones((3, 3), bool)
    return not (a & ~binary_dilation(b, k)).any() and \
        not (b & ~binary_dilation(a, k)).any()


def projected():
    corners = jboxes.boxes_to_corners_3d(BOXES, "hwl")
    return corners, camera.corners_to_camera(corners, INTRINSIC, CAM_POSE)


def viewer_frames():
    rng = np.random.default_rng(0)
    frames = []
    for k in range(3):
        box = np.array([[5.0, -3.0, 0.0, 4.0, 2.0, 1.5, 0.4 + k]])
        frames.append({
            "points": rng.uniform(-20, 20, (100, 4)).astype(np.float32),
            "gt_corners": jboxes.boxes_to_corners_3d(box, "lwh"),
            "pred_corners": jboxes.boxes_to_corners_3d(box + 0.5, "lwh"),
            "scores": np.array([0.9])})
    frames.append({"points": rng.uniform(-9, 9, (50, 3)).astype(np.float32),
                   "pred_corners": None, "gt_corners": np.zeros((0, 8, 3))})
    return frames


def test_viewer3d_html_byte_equal_to_jax(tmp_path):
    frames = viewer_frames()
    got = viewer3d.export_sequence_html(str(tmp_path / "a.html"), frames,
                                        title="seq")
    want = jviewer3d.export_sequence_html(str(tmp_path / "b.html"), frames,
                                          title="seq")
    assert open(got, "rb").read() == open(want, "rb").read()


def test_viewer3d_scene_caps_points_byte_equal_to_jax(tmp_path):
    """The one-frame wrapper and the 120 000-point cap."""
    pts = np.random.default_rng(1).uniform(-50, 50, (200000, 4)).astype(
        np.float32)
    got = viewer3d.export_scene_html(str(tmp_path / "a.html"), pts)
    want = jviewer3d.export_scene_html(str(tmp_path / "b.html"), pts)
    doc = open(got, "rb").read()
    assert doc == open(want, "rb").read()
    import json
    payload = json.loads(doc.decode().split("FRAMES=")[1].split(
        ", EDGES=")[0])
    assert len(payload[0]["pts"]) == 3 * 120000


def test_camera_projection_equals_jax():
    """corners_to_camera and filter_boxes_in_image at 1e-6."""
    corners, cam = projected()
    want = jcamera.corners_to_camera(corners, INTRINSIC, CAM_POSE)
    np.testing.assert_allclose(cam, want, atol=1e-6, rtol=0)
    assert (cam[:3, :, 2] > 0).all() and (cam[3, :, 2] < 0).all()
    got = camera.filter_boxes_in_image(cam, S, S)
    np.testing.assert_allclose(
        got, jcamera.filter_boxes_in_image(want, S, S), atol=1e-6, rtol=0)
    assert len(got) == 3


@pytest.mark.parametrize("thickness", [1, 2, 3, 4, 5])
def test_draw_2d_boxes_pixel_equal_to_cv2(thickness):
    """The boxes of the test camera and 200 random rectangles (corners
    inside, on and outside the image) against ``cv2.rectangle``."""
    _, cam = projected()
    img = np.random.default_rng(2).integers(0, 255, (S, S, 3), np.uint8)
    got = camera.draw_2d_boxes(img, cam, thickness=thickness)
    want = jcamera.draw_2d_boxes(img, cam, thickness=thickness)
    assert np.array_equal(got, want) and not np.array_equal(got, img)
    rng = np.random.default_rng(thickness)
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(4, 40, 2))
        p0, p1 = (tuple(int(v) for v in rng.integers(-8, 48, 2))
                  for _ in range(2))
        a = np.zeros((h, w, 3), np.uint8)
        cv2.rectangle(a, p0, p1, (255, 0, 9), thickness)
        b = np.zeros((h, w, 3), np.uint8)
        camera._rectangle(b, p0, p1, (255, 0, 9), thickness)
        assert np.array_equal(a, b), (p0, p1, h, w)


def test_draw_3d_boxes_within_a_pixel_of_cv2():
    """The wireframes of the test camera's boxes, and 300 random segments
    with both ends in the image, against ``cv2.line(..., LINE_AA)``."""
    _, cam = projected()
    img = np.zeros((S, S, 3), np.uint8)
    got = camera.draw_3d_boxes(img, cam)
    want = jcamera.draw_3d_boxes(img, cam)
    assert got.any() and within_a_pixel(got.any(-1), want.any(-1))
    # a box behind the camera draws nothing
    assert not camera.draw_3d_boxes(img, cam[3:]).any()
    rng = np.random.default_rng(3)
    for _ in range(300):
        p0, p1 = (tuple(int(v) for v in rng.integers(0, 64, 2))
                  for _ in range(2))
        a = np.zeros((64, 64, 3), np.uint8)
        cv2.line(a, p0, p1, (0, 255, 0), 2, cv2.LINE_AA)
        b = np.zeros((64, 64, 3), np.uint8)
        camera._thick_line(b, p0, p1, (0, 255, 0), 2)
        assert within_a_pixel(a.any(-1), b.any(-1)), (p0, p1)


def test_plot_all_agents_needs_matplotlib(tmp_path, monkeypatch):
    """With matplotlib (here) the grid figure is written; without it the
    function refuses by name."""
    img = np.zeros((16, 16, 3), np.uint8)
    fig = camera.plot_all_agents([[("camera0", img), ("camera1", None)]],
                                 ["1"], save_path=str(tmp_path / "g.png"))
    assert fig is not None and os.path.exists(tmp_path / "g.png")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="plot_all_agents needs matplotlib"):
        camera.plot_all_agents([[img]], ["1"])


def test_get_sample_and_agent_drawings_equal_jax(roots):  # noqa: F811
    """get_sample: the same agents, poses, vehicles, extrinsics and
    intrinsics (bit for bit) and images (the port's PNG read against
    ``cv2.imread`` + ``COLOR_BGR2RGB``); visualize_all_agents_bbx: the
    same (camera, image) layout, each drawing within a pixel of JAX's."""
    jroot, _ = roots
    p = params(jroot)
    ours = opv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    drawn = 0
    for ts in range(2):
        got, want = ours.get_sample(0, ts), theirs.get_sample(0, ts)
        assert list(got) == list(want)
        for cav in want:
            g, w = got[cav], want[cav]
            assert g["ego"] == w["ego"] and g["vehicles"] == w["vehicles"]
            assert g["lidar_pose"] == w["lidar_pose"]
            assert list(g["camera_params"]) == list(w["camera_params"])
            for key, wc in w["camera_params"].items():
                gc = g["camera_params"][key]
                assert gc["camera_coords"] == wc["camera_coords"]
                assert gc["image_path"] == wc["image_path"]
                for k in ("camera_extrinsic", "camera_intrinsic", "image"):
                    assert gc[k].dtype == wc[k].dtype
                    assert np.array_equal(gc[k], wc[k]), k
        g_list, g_ids = ours.visualize_all_agents_bbx(got)
        w_list, w_ids = theirs.visualize_all_agents_bbx(want)
        assert g_ids == w_ids
        for cav, g_row, w_row in zip(g_ids, g_list, w_list):
            assert [k for k, _ in g_row] == [k for k, _ in w_row]
            for (key, g_img), (_, w_img) in zip(g_row, w_row):
                raw = got[cav]["camera_params"][key]["image"]
                g_on, w_on = (g_img != raw).any(-1), (w_img != raw).any(-1)
                assert within_a_pixel(g_on, w_on), (cav, key)
                drawn += int(g_on.any())
    assert drawn > 0


def test_get_sample_reads_grey_and_alpha_as_opencv(tmp_path):
    """read_rgb: a grey PNG replicated to three channels, an alpha
    channel dropped, as ``cv2.imread`` + ``COLOR_BGR2RGB`` reads them."""
    rng = np.random.default_rng(4)
    for shape in ((9, 7), (9, 7, 4), (9, 7, 3)):
        img = rng.integers(0, 255, shape, np.uint8)
        path = str(tmp_path / f"{len(shape)}_{shape[-1]}.png")
        cv2.imwrite(path, img)
        want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        assert np.array_equal(codecs.read_rgb(path), want)


def write_maps(root, shapes, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for name, shape in shapes.items():
        cv2.imwrite(os.path.join(root, name),
                    rng.integers(0, 255, shape, np.uint8))


def test_merge_maps_equals_jax(tmp_path):
    """Equal shapes: the merged pixels equal JAX's (its BGR file read
    back as RGB); a static map of another shape: within one grey level
    after the bilinear resize.  A file that is no image is skipped."""
    dyn, sta = str(tmp_path / "d"), str(tmp_path / "s")
    write_maps(dyn, {"0.png": (20, 30, 3), "1.png": (20, 30, 3),
                     "2.png": (24, 24)}, 0)
    write_maps(sta, {"0.png": (20, 30, 3), "1.png": (13, 41, 3),
                     "2.png": (24, 24, 3)}, 1)
    for d in (dyn, sta):
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not an image")
    n = merge_maps.merge_dynamic_static(dyn, sta, str(tmp_path / "p"))
    assert n == jmerge.merge_dynamic_static(dyn, sta, str(tmp_path / "j"))
    for name in ("0.png", "1.png", "2.png"):
        got = codecs.read_png(str(tmp_path / "p" / name))
        want = cv2.cvtColor(cv2.imread(str(tmp_path / "j" / name)),
                            cv2.COLOR_BGR2RGB)
        assert got.shape == want.shape
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        assert diff <= (1 if name == "1.png" else 0), (name, diff)
    assert not os.path.exists(tmp_path / "p" / "notes.txt")


@pytest.mark.parametrize("size", [(7, 19), (40, 11), (16, 16)])
def test_resize_bilinear_of_any_shape_within_a_level_of_cv2(size):
    img = np.random.default_rng(5).integers(0, 255, (23, 17, 3), np.uint8)
    got = codecs.resize_bilinear(img, size)
    want = cv2.resize(img, (size[1], size[0]), interpolation=cv2.INTER_LINEAR)
    assert got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_bev_raster_shape_points_and_ring_edges(tmp_path):
    """The image of the window at the long side's pixels, points white,
    the ground-truth rings lime and the predicted rings red (drawn last)
    at the pixels of their corners and edge midpoints."""
    rng = np.random.default_rng(0)
    rng_ = [-50, -25, -3, 50, 25, 1]
    pts = rng.uniform([-50, -25, 0], [50, 25, 1], (1000, 3))
    gt = boxes_to_corners_3d_np(np.array([[10, 5, 0, 1.5, 2.0, 4.5, 0.3]]),
                                "hwl")
    pred = boxes_to_corners_3d_np(np.array([[-20, -8, 0, 1.5, 2.0, 4.5, 1.1]]),
                                  "hwl")
    path = str(tmp_path / "f.png")
    img = vis.visualize_bev(pts, pred, gt, rng_, save_path=path)
    assert img.shape == (600, 1200, 3) == vis.bev_shape(rng_) + (3,)
    assert np.array_equal(codecs.read_png(path), img)
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    assert colours == {(0, 0, 0), vis.WHITE, vis.LIME, vis.RED}
    for corners, colour in ((gt, vis.LIME), (pred, vis.RED)):
        ring = corners[0, :4, :2]
        rows, cols = vis.bev_pixel(ring, rng_, img.shape[:2])
        assert all(tuple(img[r, c]) == colour for r, c in zip(rows, cols))
        # nine points along each edge: the colour within a pixel of each
        t = np.linspace(0.1, 0.9, 9)[:, None, None]
        along = ring[None] + t * (np.roll(ring, -1, axis=0) - ring)[None]
        rows, cols = vis.bev_pixel(along.reshape(-1, 2), rng_, img.shape[:2])
        for r, c in zip(rows, cols):
            near = img[r - 1:r + 2, c - 1:c + 2].reshape(-1, 3)
            assert (near == colour).all(-1).any(), (r, c)
    rows, cols = vis.bev_pixel(pts, rng_, img.shape[:2])
    on = img[rows, cols]
    white = (on == vis.WHITE).all(-1)
    # every point is white unless a ring is drawn over it
    assert white.mean() > 0.99
    assert ((on == vis.LIME).all(-1) | (on == vis.RED).all(-1))[~white].all()


def test_bev_ring_crossing_the_window_edge_keeps_its_direction():
    """A ring with corners far outside the window: each edge is clipped
    along its own direction, so every pixel drawn lies within a pixel of
    the edge's true line, and the edges' inside parts are drawn."""
    rng_ = [-50, -25, -3, 50, 25, 1]
    # a long box from inside the window to x = 2 000 m, at a slant
    box = np.array([[1000, 0, 0, 1.5, 12.0, 2000.0, 0.004]])
    ring = boxes_to_corners_3d_np(box, "hwl")[0, :4, :2]
    img = vis.render_bev(None, ring[None], None, rng_)
    h, w = img.shape[:2]
    drawn = np.argwhere((img == vis.RED).all(-1))
    assert len(drawn)
    # the true lines through the corners' pixel positions
    x0, y0, x1, y1 = rng_[0], rng_[1], rng_[3], rng_[4]
    pix = np.stack([(y1 - ring[:, 1]) / (y1 - y0) * h,
                    (ring[:, 0] - x0) / (x1 - x0) * w], -1)
    dist = []
    for a in range(4):
        p, q = pix[a], pix[(a + 1) % 4]
        d = (q - p) / np.linalg.norm(q - p)
        rel = drawn + 0.5 - p
        dist.append(np.abs(rel[:, 0] * d[1] - rel[:, 1] * d[0]))
    assert np.min(dist, axis=0).max() <= 1.5
    # each long edge (1 and 3) runs from x = 0 (the middle column) out
    # through the right edge
    for a in (1, 3):
        p, q = pix[a], pix[(a + 1) % 4]
        for col in (w // 2 + 10, 3 * w // 4, w - 1):
            r = p[0] + (col + 0.5 - p[1]) / (q[1] - p[1]) * (q[0] - p[0])
            if 1 <= r < h - 1:
                near = img[int(r) - 1:int(r) + 2, col].reshape(-1, 3)
                assert (near == vis.RED).all(-1).any(), (a, col)


def test_visualize_seg_writes_viridis(tmp_path):
    seg = np.random.default_rng(0).integers(0, 3, (64, 64))
    img = vis.visualize_seg(seg, save_path=str(tmp_path / "s.png"))
    assert img.shape == (512, 512, 3)
    assert np.array_equal(codecs.read_png(str(tmp_path / "s.png")), img)
    assert tuple(img[0, 0]) == tuple(vis.seg_colours(seg)[0, 0])
    for classes in ([[0, 2]], [[1, 2]], [[-3, 5]]):
        assert [tuple(c) for c in vis.seg_colours(np.array(classes))[0]] == \
            [(68, 1, 84), (253, 231, 37)]
    logits = np.random.default_rng(1).normal(size=(3, 8, 8))
    assert np.array_equal(vis.visualize_seg(logits)[::64, ::64],
                          vis.seg_colours(logits.argmax(0)))


def test_vis_npy_renderer(tmp_path):
    box = np.array([[5.0, -3.0, 0.0, 4.0, 2.0, 1.5, 0.4]])
    corners = boxes_to_corners_3d_np(box, "lwh")
    npy_dir = tmp_path / "npy"
    npy_dir.mkdir()
    for i in range(2):
        np.save(npy_dir / f"{i:04d}_pred.npy", corners + 0.3)
        np.save(npy_dir / f"{i:04d}_gt.npy", corners)
    paths = vis_npy.render_npy_dir(str(npy_dir))
    assert [os.path.basename(p) for p in paths] == ["0000.png", "0001.png"]
    for p in paths:
        assert codecs.read_png(p).shape == (1200, 1200, 3)
    assert os.path.exists(npy_dir / "vis" / "sequence.html")


def test_sequence_renderer(roots, tmp_path):  # noqa: F811
    """vis_frame equals JAX's (the merged cloud and the ground truth);
    render_sequence writes the numbered PNGs and the viewer, byte-equal
    to JAX's viewer of the same frames."""
    from hmvit_tpu.visualization.sequence import vis_frame as jvis_frame

    jroot, _ = roots
    p = params(jroot)
    ours = opv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    for i in range(2):
        got, want = sequence.vis_frame(ours, i), jvis_frame(theirs, i)
        assert np.array_equal(got["points"], want["points"])
        np.testing.assert_allclose(got["gt_corners"], want["gt_corners"],
                                   atol=1e-12, rtol=0)
    out = str(tmp_path / "seq")
    paths = sequence.render_sequence(ours, out, indices=[0, 1], gif=False)
    assert [os.path.basename(q) for q in paths] == ["frame_00000.png",
                                                    "frame_00001.png"]
    want = jviewer3d.export_sequence_html(
        str(tmp_path / "j.html"),
        [dict(jvis_frame(theirs, i), pred_corners=None, scores=None)
         for i in range(2)])
    assert open(os.path.join(out, "sequence.html"), "rb").read() == \
        open(want, "rb").read()
