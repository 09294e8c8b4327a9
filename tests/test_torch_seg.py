"""Port parity of the segmentation assemblies: ``BevSegHead``, its loss,
post-processing and IoU, the box rasterizer, the BEV map ground truth
of the dataset (``add_data_extension``, ``seg_labels``) and the fixture's
rasters, ``CameraSegmentor`` and the cooperative ``task: seg``, against
the JAX package on the CPU (the same weights through the bridge, the
same seeded numpy inputs).

* Within 1e-5 over max(1, max |ref|): ``BevSegHead`` (each target),
  ``seg_loss`` (value and gradient), ``seg_post_process``, ``seg_iou``.
* Bit for bit: ``rasterize_boxes_to_mask``; the map ground truth and
  ``seg_labels`` of every frame of the fixture, at several
  ``seg_gt_size`` and head grids, from the rasters and from the boxes;
  the JAX and the port fixture writers' raster pixels.
* OpenCV's grey conversion and nearest resize, pinned against ``cv2``
  itself: the grey formula on every 8-bit colour, the PNG read on
  unequal channels and odd sizes (100 -> 128, 300 -> 256), the nearest
  source index on sizes where ``i * n // size`` would differ from it.
* Within 1e-4: each camera segmentation assembly (CVT, FAX, VPN,
  VPN-MS, BEVSwap under ``CameraSegmentor``; F-Cooper, attention,
  DiscoNet, SwapFusion and V2VNet under ``task: seg``) at the camera zoo
  test's shapes, with the flax parameter count.
* One train step of ``cvt_seg``: the port in float32 against the JAX
  step in float64 (``torch_parity.held_to_yardstick``).
* The tools: ``tools.train`` of ``smoke_camera_seg_tiny.yaml`` on the
  map ground truth, and ``tools.inference`` refusing its run directory.
"""
import copy
import glob
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.data import opv2v as jopv2v
from hmvit_tpu.data.fixture import write_mini_opv2v as jwrite
from hmvit_tpu.models import seg_head as jseg
from hmvit_tpu.models import zoo as jzoo
from hmvit_tpu_torch.config import load_config
from hmvit_tpu_torch.data import codecs, opv2v
from hmvit_tpu_torch.data.fixture import write_mini_opv2v
from hmvit_tpu_torch.models import seg_head, zoo
from torch_parity import bridged, close, flax_variables, japply, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_HYPES = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes")
SEG_SMOKE = os.path.join(PORT_HYPES, "smoke_camera_seg_tiny.yaml")
RANGE = [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def scaled_close(got, want, atol):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    close(got / scale, np.asarray(want) / scale, atol)


# -- head, loss, post-processing, IoU ---------------------------------------

@pytest.mark.parametrize("target", ["dynamic", "static", "both"])
def test_bev_seg_head_matches_jax(target):
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 16)).astype(
        np.float32)
    jm = jseg.BevSegHead(target)
    v = flax_variables(jm, x)
    want = japply(jm, v, x)
    got = bridged(seg_head.BevSegHead(16, target), v)(t(x))
    assert set(got) == set(want)
    for k in got:  # NHWC, as JAX returns it
        assert tuple(got[k].shape) == want[k].shape == (
            2, 8, 8, 2 if k == "dynamic_seg" else 3)
        scaled_close(got[k].detach(), want[k], 1e-5)


def seg_outputs(seed, with_static=True):
    rng = np.random.default_rng(seed)
    out = {"dynamic_seg": rng.standard_normal((2, 16, 16, 2)).astype(
        np.float32) * 3}
    labels = {"dynamic_seg": (rng.uniform(size=(2, 16, 16)) < 0.2).astype(
        np.int32)}
    if with_static:
        out["static_seg"] = rng.standard_normal((2, 16, 16, 3)).astype(
            np.float32) * 3
        labels["static_seg"] = rng.integers(0, 3, (2, 16, 16)).astype(
            np.int32)
    return out, labels


@pytest.mark.parametrize("with_static", [True, False],
                         ids=["both", "dynamic"])
def test_seg_loss_value_and_gradient_match_jax(with_static):
    out, labels = seg_outputs(1, with_static)
    kw = {"d_weights": 75.0, "s_weights": 15.0}

    def jloss(o):
        return jseg.seg_loss(o, {k: jnp.asarray(v) for k, v in
                                 labels.items()}, **kw)

    (want, wparts), wgrad = jax.value_and_grad(jloss, has_aux=True)(
        {k: jnp.asarray(v) for k, v in out.items()})
    logits = {k: t(v).requires_grad_(True) for k, v in out.items()}
    got, parts = seg_head.seg_loss(
        logits, {k: t(v) for k, v in labels.items()}, **kw)
    got.backward()
    assert set(parts) == set(wparts)
    for k in parts:
        scaled_close(parts[k].detach(), wparts[k], 1e-5)
    for k, v in logits.items():
        scaled_close(v.grad, wgrad[k], 1e-5)


def test_seg_post_process_and_iou_match_jax():
    out, labels = seg_outputs(2)
    # a tie: argmax takes the first class in both
    out["static_seg"][0, 0, 0] = (1.0, 1.0, 0.0)
    want = jseg.seg_post_process({k: jnp.asarray(v) for k, v in out.items()})
    got = seg_head.seg_post_process({k: t(v) for k, v in out.items()})
    assert set(got) == set(want)
    for k in got:
        if k.endswith("_map"):
            assert np.array_equal(got[k].numpy(), np.asarray(want[k]))
        else:
            scaled_close(got[k], want[k], 1e-5)
    for key, n in (("dynamic", 2), ("static", 3)):
        pred = got[f"{key}_map"].numpy()
        assert seg_head.seg_iou(pred, labels[f"{key}_seg"], n) == \
            jseg.seg_iou(pred, labels[f"{key}_seg"], n)
    assert seg_head.seg_iou(np.zeros((4, 4)), np.zeros((4, 4)))["miou"] == \
        jseg.seg_iou(np.zeros((4, 4)), np.zeros((4, 4)))["miou"]


@pytest.mark.parametrize("name", ["vanilla_seg_loss", "seg_loss"])
def test_build_loss_picks_seg_loss_as_the_jax_tool_does(name):
    """The JAX ``tools/train.py`` takes ``seg_loss`` with ``d_weights``
    / ``s_weights`` (defaults 75 and 15) for both names; the port's
    ``build_loss`` does."""
    from hmvit_tpu_torch.train.losses import build_loss

    fn, kw = build_loss({"core_method": name, "args": {"d_weights": 50}})
    assert fn is seg_head.seg_loss
    assert kw == {"d_weights": 50.0, "s_weights": 15.0}


@pytest.mark.parametrize("order", ["hwl", "lwh"])
def test_rasterize_boxes_to_mask_bit_for_bit(order):
    rng = np.random.default_rng(3)
    boxes = np.concatenate([rng.uniform(-20, 20, (7, 2)),
                            rng.uniform(-1.5, -0.5, (7, 1)),
                            rng.uniform(1.4, 5.0, (7, 3)),
                            rng.uniform(-np.pi, np.pi, (7, 1))], 1)
    for hw in ((16, 16), (32, 24), (100, 100)):
        got = seg_head.rasterize_boxes_to_mask(boxes, RANGE, hw, order)
        want = jseg.rasterize_boxes_to_mask(boxes, RANGE, hw, order)
        assert got.dtype == want.dtype == np.uint8
        assert np.array_equal(got, want) and got.any()
    for empty in (None, np.zeros((0, 7))):
        assert np.array_equal(
            seg_head.rasterize_boxes_to_mask(empty, RANGE, (8, 8)),
            jseg.rasterize_boxes_to_mask(empty, RANGE, (8, 8)))


# -- OpenCV's grey conversion and nearest resize ------------------------------

def test_grey_formula_equals_opencv_on_every_colour():
    v = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([(v >> 16) & 255, (v >> 8) & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)
    want = cv2.cvtColor(np.ascontiguousarray(rgb[..., ::-1]),
                        cv2.COLOR_BGR2GRAY)
    assert np.array_equal(codecs.grey_of(rgb), want)


@pytest.mark.parametrize("n,size", [(100, 128), (300, 256), (128, 128),
                                    (257, 100), (3, 147), (2, 98)])
def test_grey_read_and_nearest_resize_equal_opencv(tmp_path, n, size):
    """Unequal channels (so a wrong grey formula shows), then the
    nearest resize as ``_load_bev_gt`` chains them."""
    rng = np.random.default_rng(n + size)
    rgb = rng.integers(0, 256, (n, n, 3), dtype=np.uint8)
    path = str(tmp_path / "map.png")
    codecs.write_png(path, rgb)
    want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)
    got = codecs.read_grey(path)
    assert np.array_equal(got, want)
    want = cv2.resize(want, (size, size), interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(codecs.resize_nearest(got, size), want)
    if (n, size) in ((3, 147), (2, 98)):  # the integer rule's trap
        naive = got[np.arange(size) * n // size]
        assert not np.array_equal(naive[:, np.arange(size) * n // size],
                                  want)
    # a grey file reads replicated
    codecs.write_png(path, rgb[..., 0])
    assert np.array_equal(codecs.read_grey(path), cv2.cvtColor(
        cv2.imread(path), cv2.COLOR_BGR2GRAY))


# -- the map ground truth of the fixture --------------------------------------

@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """(JAX fixture root, port fixture root) of the same arguments."""
    jroot = str(tmp_path_factory.mktemp("jax_seg_fixture"))
    proot = str(tmp_path_factory.mktemp("port_seg_fixture"))
    kw = dict(num_cavs=2, num_frames=3, image_size=32, max_points=512,
              seed=5, area=20.0)
    jwrite(jroot, **kw)
    write_mini_opv2v(proot, **kw)
    return jroot, proot


def test_fixture_bev_rasters_equal_jax_writer(roots):
    jroot, proot = roots
    names = sorted(os.path.relpath(f, proot) for f in glob.glob(
        os.path.join(proot, "**", "*_bev_*.png"), recursive=True))
    assert names == sorted(os.path.relpath(f, jroot) for f in glob.glob(
        os.path.join(jroot, "**", "*_bev_*.png"), recursive=True))
    assert len(names) == 2 * 3 * 4
    for name in names:
        a = cv2.imread(os.path.join(jroot, name))
        b = codecs.read_png(os.path.join(proot, name))[..., ::-1]
        assert np.array_equal(a, b), name


def seg_params(root, **extra):
    params = load_config(SEG_SMOKE)
    params["root_dir"] = params["validate_dir"] = root
    params["preprocess"]["args"]["camera_preprocess"]["args"]["resize_x"] = 32
    for key, value in extra.items():
        if key == "seg_gt_size":
            params["postprocess"]["seg_gt_size"] = value
        elif key == "visible":
            params["train_params"]["visible"] = value
        else:
            params[key] = value
    return params


@pytest.mark.parametrize("gt_size,visible", [(128, False), (100, True),
                                             (300, False)])
def test_map_ground_truth_and_labels_bit_for_bit(roots, gt_size, visible):
    """Every frame's ``gt_dynamic`` / ``gt_static`` / ``has_map_gt``
    and its ``seg_labels`` at three head grids, port dataset against JAX
    dataset on the JAX writer's fixture."""
    p = seg_params(roots[0], seg_gt_size=gt_size, visible=visible)
    ours = opv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    assert len(ours) == len(theirs) == 3
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        for k in ("gt_dynamic", "gt_static"):
            assert got[k].dtype == want[k].dtype == np.uint8
            assert got[k].shape == (gt_size, gt_size)
            assert np.array_equal(got[k], want[k]), k
        assert got["has_map_gt"] == want["has_map_gt"] == 1.0
        assert set(np.unique(got["gt_static"])) == {0, 1, 2}
        for grid in ((16, 16), (37, 37), (128, 128)):
            a, b = ours.seg_labels(got, grid), theirs.seg_labels(want, grid)
            assert set(a) == set(b) == {"dynamic_seg", "static_seg"}
            for k in a:
                assert np.array_equal(a[k], b[k]), (grid, k)


def test_labels_from_boxes_without_rasters(roots, tmp_path):
    """Without the dynamic raster: ``has_map_gt`` 0, and the labels are
    the frame's boxes rasterized, bit for bit."""
    import shutil

    root = str(tmp_path / "fixture")
    shutil.copytree(roots[0], root)
    for f in glob.glob(os.path.join(root, "**", "*_bev_dynamic.png"),
                       recursive=True):
        os.remove(f)
    p = seg_params(root)
    ours = opv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    theirs = jopv2v.HeteroCooperativeDataset(p, train=False, max_points=512)
    for i in range(len(ours)):
        got, want = ours[i], theirs[i]
        assert got["has_map_gt"] == want["has_map_gt"] == 0.0
        assert np.array_equal(got["gt_static"], want["gt_static"])
        a, b = ours.seg_labels(got, (24, 24)), theirs.seg_labels(want,
                                                                 (24, 24))
        assert set(a) == set(b) == {"dynamic_seg"}
        assert np.array_equal(a["dynamic_seg"], b["dynamic_seg"])
        assert a["dynamic_seg"].any() or not got["object_bbx_mask"].any()


# -- the assemblies -----------------------------------------------------------

TRUNK = {"dim": 32, "out_dim": 48, "encoder_channels": [16, 16, 32, 32]}
CAMERAS = {
    "cvt": dict(TRUNK, encoder="cvt", bev_size=4, num_blocks=1,
                decoder_layers=2),
    "fax": dict(TRUNK, encoder="fax", bev_size=8, bev_window=4, depth=1,
                decoder_layers=1, heads=2, dim_head=16),
    "vpn": dict(TRUNK, encoder="vpn", bev_size=8, decoder_layers=1,
                img_size=64),
    "vpn_ms": dict(TRUNK, encoder="vpn_ms", bev_size=4, decoder_layers=2,
                   img_size=64, encoder_channels=[16, 32, 32]),
    "bev_swap": dict(TRUNK, encoder="bev_swap", bev_size=8, window=4,
                     num_blocks=1, upsample=1, dim_head=16, num_cams=4),
}
SPATIAL = {"downsample_rate": 4, "voxel_size": [0.64, 0.64, 4.0]}
# (core_method, camera, extra model args)
ASSEMBLIES = {
    "cvt_seg": ("cvt_seg", "cvt", {"target": "both"}),
    "fax_fused_transformer": ("fax_fused_transformer", "fax",
                              {"target": "static"}),
    "view_parse_network": ("view_parse_network", "vpn", {}),
    "view_parse_network_ms": ("view_parse_network_ms", "vpn_ms", {}),
    "bev_swap": ("bev_swap", "bev_swap", {}),
    "corpbevt_seg_task": ("corpbevt", "fax", {"task": "seg"}),
    "cvt_fcooper_seg_task": ("cvt_fcooper", "cvt", {"task": "seg",
                                                     "target": "both"}),
    "cvt_att_fuse_seg_task": ("cvt_att_fuse", "cvt", {
        "task": "seg", "decoder": {"num_layer": 1, "num_ch_dec": [32]}}),
    "cvt_disconet_seg_task": ("cvt_disconet", "cvt", {"task": "seg"}),
    "vpn_v2vnet_seg_task": ("view_parse_network_v2vnet", "vpn",
                            {"task": "seg"}),
}


def seg_model_cfg(name: str) -> dict:
    core_method, camera, extra = ASSEMBLIES[name]
    camera = dict(CAMERAS[camera])
    if core_method in ("fax_fused_transformer", "view_parse_network",
                       "view_parse_network_ms", "bev_swap",
                       "view_parse_network_v2vnet"):
        camera.pop("encoder")  # the name's default encoder
    args = {"camera": camera, "spatial_transform": SPATIAL,
            "anchor_number": 2, **copy.deepcopy(extra)}
    return {"core_method": core_method, "args": args}


@pytest.fixture(scope="module")
def camera_batch():
    """Two camera agents of 4 x 64^2 cameras and a padded slot."""
    from hmvit_tpu.data.synthetic import make_hetero_batch

    batch, _ = make_hetero_batch(
        seed=3, max_cav=3, num_agents=2, max_points=64, image_size=64,
        num_cams=4, camera_ratio=1.0, ego_mode="camera", lidar_range=RANGE)
    batch["mode"][:] = 0
    return batch


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_seg_assembly_matches_jax(camera_batch, name):
    model_cfg = seg_model_cfg(name)
    jm = jzoo.build_model(model_cfg)
    jb = {k: jnp.asarray(v) for k, v in camera_batch.items()}
    v = flax_variables(jm, jb, train=False)
    pm = bridged(zoo.build_model(model_cfg), v)
    assert type(pm).__name__ == type(jm).__name__
    n_flax = sum(int(np.prod(x.shape))
                 for x in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    ref = japply(jm, v, jb, train=False)
    with torch.no_grad():
        out = pm({k: t(x) for k, x in camera_batch.items()})
    target = model_cfg["args"].get("target", "dynamic")
    assert set(out) == set(ref) == {
        "dynamic": {"dynamic_seg"}, "static": {"static_seg"},
        "both": {"dynamic_seg", "static_seg"}}[target]
    for k in out:
        assert tuple(out[k].shape) == ref[k].shape
        assert out[k].shape[-1] == (2 if k == "dynamic_seg" else 3)
        close(out[k], ref[k], 1e-4)


# -- one train step -----------------------------------------------------------

def test_cvt_seg_train_step_matches_jax(camera_batch):
    from hmvit_tpu_torch.bridge import flax_to_state_dict
    from hmvit_tpu_torch.train.trainer import create_train_state, \
        make_train_step
    from torch_parity import held_to_yardstick, jax_adamw_steps

    cfg = seg_model_cfg("cvt_seg")
    jm = jzoo.build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in camera_batch.items()}
    variables = flax_variables(jm, jb, train=False)
    h = japply(jm, variables, jb, train=False)["dynamic_seg"].shape[1]
    boxes = camera_batch["object_bbx_center"][0][
        camera_batch["object_bbx_mask"][0] > 0]
    dyn = seg_head.rasterize_boxes_to_mask(boxes, RANGE, (h, h))
    rng = np.random.default_rng(4)
    labels = {"dynamic_seg": dyn[None].astype(np.int32),
              "static_seg": rng.integers(0, 3, (1, h, h)).astype(np.int32)}
    assert labels["dynamic_seg"].any()

    def jloss(out, lab):
        return jseg.seg_loss(out, lab, d_weights=75.0, s_weights=15.0)

    ref = {x64: jax_adamw_steps(jm, variables, camera_batch, labels, x64,
                                1e-3, 1e-2, steps=1, loss=jloss)[0][0]
           for x64 in (True, False)}
    model = bridged(zoo.build_model(cfg), variables)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, loss_fn=seg_head.seg_loss,
                           loss_kwargs={"d_weights": 75.0,
                                        "s_weights": 15.0})
    state, parts = step(state, {k: t(v) for k, v in camera_batch.items()},
                        {k: t(v) for k, v in labels.items()})
    grads = {n: p.grad for n, p in model.named_parameters()}

    def layout(tree):
        return flax_to_state_dict(zoo.build_model(cfg), {
            "params": tree[1], "batch_stats": tree[2]})

    (loss64, g64), (_, g32) = ((r[0], layout(r)) for r in (ref[True],
                                                           ref[False]))
    assert abs(float(parts["total_loss"]) - loss64) <= 1e-5 * abs(loss64)
    worst = held_to_yardstick(grads, g64, g32, 1e-4)
    assert worst[0] <= 1.0, worst


# -- the tools ----------------------------------------------------------------

def test_tools_train_seg_and_inference_refuses_it(tmp_path):
    """``tools.train`` of ``smoke_camera_seg_tiny.yaml`` (CVT, both
    targets, the map ground truth through ``add_data_extension``) for two
    steps on the CPU; ``tools.inference`` then refuses the run directory
    by name: the JAX tool evaluates detectors only."""
    import json

    from hmvit_tpu_torch.tools import inference, train

    run = str(tmp_path / "run")
    train.main(["--hypes_yaml", SEG_SMOKE, "--model_dir", run,
                "--synthetic", "--epoches", "1", "--steps_per_epoch", "2",
                "--max_points", "1024", "--cpu"])
    with open(os.path.join(run, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert {"dynamic_seg", "static_seg", "total_loss"} <= set(rec)
    assert np.isfinite(rec["total_loss"])
    assert os.path.exists(os.path.join(run, "ckpt", "1", "state.pt"))
    with pytest.raises(SystemExit, match="segmentation run directory"):
        inference.main(["--model_dir", run, "--synthetic", "--cpu"])
