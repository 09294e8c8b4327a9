"""Port parity of the lidar zoo: VoxelNet, SECOND and PIXOR with the
anchor-free decode (``models/lidar_zoo.py``, ``models/pixor.py``,
``postprocess_bev.py``), the same weights through the bridge and the
same inputs (numpy, seeded) against the JAX package on the CPU.

* The blocks at the JAX test's shapes (``tests/test_lidar_zoo.py``: two
  clouds of 2048 points in +-20.48 m, a 64 x 64 x 8 voxel grid, 64 x 64
  x 24 for SECOND, a 0.64 m PIXOR raster), within 1e-5 over max(1, max
  |ref|): ``bev_raster``, ``mean_voxel_grid``, ``VoxelFeatureNet``,
  ``VoxelCML``, ``VoxelRPN``, ``VoxelBackbone8x``, ``PixorBackbone``
  (with and without BatchNorm) and ``PixorHeader``, in eval mode; in
  train mode (the outputs and the running statistics after the update,
  which hold each block's own BatchNorm momentum) within 1e-4 over
  scale: each train-mode BatchNorm renormalises by its batch's float32
  statistics, so over the 11 to 40 of them in a trunk the summation
  order's noise grows (VoxelBackbone8x's statistics read 1.9e-5 from
  JAX's, the PIXOR trunk's 1.2e-5).
* The assemblies through ``build_model`` (``voxel_net``, ``second``,
  ``pixor``, ``voxel_net_intermediate``, ``pixor_intermediate``,
  ``second_intermediate``) on a two-agent batch with a padded slot:
  the outputs within 1e-4, the flax parameter count.
* The anchor-free labels bit for bit (``bev_label_map``, the trainer's
  ``labels_for_batch``); ``decode_bev_device`` and
  ``BevPostprocessor.post_process`` within 1e-4 on the kept sets (tied
  scores may reorder).
* One train step of ``pixor_intermediate``: the port in float32 against
  the JAX step in float64, by ``torch_parity.held_to_yardstick``.
* SECOND's z-chain ValueError; the tools' PIXOR run directory (train,
  then inference with the ``cls`` / ``reg`` view and the lifted
  corners) on the CPU.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu import postprocess_bev as jpost
from hmvit_tpu.models import lidar_zoo as jlz
from hmvit_tpu.models import pixor as jpixor
from hmvit_tpu.models import zoo as jzoo
from hmvit_tpu_torch import postprocess_bev as post
from hmvit_tpu_torch.bridge import flax_to_state_dict
from hmvit_tpu_torch.models import lidar_zoo, pixor, zoo
from torch_parity import bridged, close, flax_variables, japply, t

RANGE = [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0]
CFG = {"voxel_size": [0.64, 0.64, 0.5], "lidar_range": RANGE,
       "grid_size": (64, 64, 8), "anchor_number": 2, "vfe_filters": 16}
SECOND_CFG = dict(CFG, voxel_size=[0.64, 0.64, 4.0 / 24],
                  grid_size=(64, 64, 24),
                  base_bev_backbone={
                      "layer_nums": [1, 1], "layer_strides": [1, 2],
                      "num_filters": [32, 32], "upsample_strides": [1, 2],
                      "num_upsample_filter": [32, 32]})
PIXOR_CFG = {"res": 0.64, "downsample_rate": 4, "lidar_range": RANGE,
             "use_bn": True}
GEOMETRY = pixor.geometry_from_config(
    {"res": 0.64, "downsample_rate": 4, "cav_lidar_range": RANGE})


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def make_points(seed=0, n=2, p=2048):
    """The JAX test's clouds: uniform in the range, the second half of
    each padding."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, p, 4), np.float32)
    pts[..., 0] = rng.uniform(-20, 20, (n, p))
    pts[..., 1] = rng.uniform(-20, 20, (n, p))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (n, p))
    pts[..., 3] = rng.uniform(0, 1, (n, p))
    mask = np.ones((n, p), np.float32)
    mask[:, p // 2:] = 0
    return pts, mask


def scaled_close(got, want, atol):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    close(got / scale, np.asarray(want) / scale, atol)


def test_geometry_and_raster_match_jax():
    assert GEOMETRY == jpixor.geometry_from_config(
        {"res": 0.64, "downsample_rate": 4, "cav_lidar_range": RANGE})
    pts, mask = make_points(1)
    pts[0, :4, 0] = [-20.48, 20.47, 25.0, -30.0]  # edges and outside
    want = np.asarray(jpixor.bev_raster(jnp.asarray(pts), jnp.asarray(mask),
                                        GEOMETRY))
    got = pixor.bev_raster(t(pts), t(mask), GEOMETRY)
    assert tuple(got.shape) == want.shape == (2, 64, 64, 7)
    assert got.dtype == torch.float32
    assert np.array_equal(got[..., :-1].numpy(), want[..., :-1])
    scaled_close(got, want, 1e-5)


def test_mean_voxel_grid_matches_jax():
    pts, mask = make_points(2)
    args = (SECOND_CFG["voxel_size"], RANGE, SECOND_CFG["grid_size"])
    want = jlz.mean_voxel_grid(jnp.asarray(pts), jnp.asarray(mask), *args,
                               max_points_per_voxel=2)
    got = lidar_zoo.mean_voxel_grid(t(pts), t(mask), *args,
                                    max_points_per_voxel=2)
    assert tuple(got.shape) == want.shape == (2, 24, 64, 64, 4)
    scaled_close(got, want, 1e-5)


def test_fold_z_to_channels_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 4, 5, 6)).astype(
        np.float32)
    assert np.array_equal(lidar_zoo.fold_z_to_channels(t(x)).numpy(),
                          np.asarray(jlz.fold_z_to_channels(jnp.asarray(x))))


TRAIN_ATOL = 1e-4


def block_parity(jm, pm, inputs, train):
    """The block's output (and, in train mode, its running statistics
    after the update) against the JAX module's: 1e-5 over scale in eval
    mode, ``TRAIN_ATOL`` in train mode."""
    v = flax_variables(jm, *inputs, train=False)
    pm = bridged(pm, v)
    atol = TRAIN_ATOL if train else 1e-5
    if not train:
        want = japply(jm, v, *inputs, train=False)
        with torch.no_grad():
            got = pm(*(t(a) for a in inputs))
    else:
        want, upd = jax.jit(lambda v, *a: jm.apply(
            v, *a, train=True, mutable=["batch_stats"]))(v, *inputs)
        with torch.no_grad():
            got = pm.train()(*(t(a) for a in inputs))
        if "batch_stats" in v:
            stats = flax_to_state_dict(pm, {
                "params": v["params"], "batch_stats": upd["batch_stats"]})
            for k, ra in pm.state_dict().items():
                if "running" in k:
                    scaled_close(ra, stats[k].numpy(), atol)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        scaled_close(g, w, atol)


def rnd(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


BLOCKS = {
    "voxel_feature_net": (
        lambda: jlz.VoxelFeatureNet(16, CFG["voxel_size"], RANGE,
                                    CFG["grid_size"]),
        lambda: lidar_zoo.VoxelFeatureNet(16, CFG["voxel_size"], RANGE,
                                          CFG["grid_size"]),
        lambda: make_points(4)),
    "voxel_cml": (jlz.VoxelCML, lambda: lidar_zoo.VoxelCML(16),
                  lambda: (rnd(2, 8, 16, 16, 16, seed=5),)),
    "voxel_rpn": (lambda: jlz.VoxelRPN(2), lambda: lidar_zoo.VoxelRPN(64, 2),
                  lambda: (rnd(1, 32, 32, 64, seed=6),)),
    "voxel_backbone8x": (jlz.VoxelBackbone8x, lidar_zoo.VoxelBackbone8x,
                         lambda: (rnd(1, 25, 32, 32, 4, seed=7),)),
    "pixor_backbone": (jpixor.PixorBackbone,
                       lambda: pixor.PixorBackbone(7),
                       lambda: (rnd(1, 64, 64, 7, seed=8),)),
    "pixor_backbone_no_bn": (lambda: jpixor.PixorBackbone(use_bn=False),
                             lambda: pixor.PixorBackbone(7, use_bn=False),
                             lambda: (rnd(1, 64, 64, 7, seed=9),)),
    "pixor_header": (jpixor.PixorHeader, pixor.PixorHeader,
                     lambda: (rnd(2, 16, 16, 96, seed=10),)),
}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name, train):
    jm, pm, inputs = BLOCKS[name]
    block_parity(jm(), pm(), inputs(), train)


def test_pixor_header_starts_with_zero_regression():
    from hmvit_tpu_torch.nn import init_parameters

    head = init_parameters(pixor.PixorHeader(), 0)
    assert not head.Conv_5.weight.any() and head.Conv_4.weight.any()
    assert not head.Conv_4.bias.any()


def test_second_z_chain_collapse_raises():
    """nz 8 leaves no z cell after conv_out (the JAX module raises the
    same ValueError at its first call; the port at construction)."""
    with pytest.raises(ValueError, match="collapses"):
        lidar_zoo.SecondDetector(dict(SECOND_CFG, grid_size=(64, 64, 8)))
    points, mask = make_points(0)
    jm = jlz.SecondDetector(dict(SECOND_CFG, grid_size=(64, 64, 8)))
    with pytest.raises(ValueError, match="collapses"):
        jm.init(jax.random.key(0), jnp.asarray(points), jnp.asarray(mask))
    assert lidar_zoo.second_depth(24) == 1 and lidar_zoo.second_depth(40) == 2


# -- the assemblies -----------------------------------------------------------

@pytest.fixture(scope="module")
def lidar_batch():
    """Two lidar agents (rigid poses from the synthetic scene) and a
    padded slot, 2048 points each."""
    from hmvit_tpu.data.synthetic import make_hetero_batch

    batch, _ = make_hetero_batch(
        seed=3, max_cav=3, num_agents=2, max_points=2048, image_size=8,
        num_cams=1, camera_ratio=0.0, ego_mode="lidar", lidar_range=RANGE)
    return batch


SPATIAL = {"downsample_rate": 8, "voxel_size": SECOND_CFG["voxel_size"]}
ASSEMBLIES = {
    "voxel_net": ({"lidar": CFG}, "psm"),
    "second": ({"lidar": SECOND_CFG}, "psm"),
    "pixor": ({"lidar": PIXOR_CFG}, "cls"),
    "voxel_net_intermediate": ({"lidar": CFG}, "psm"),
    "pixor_intermediate": ({"lidar": PIXOR_CFG}, "cls"),
    "second_intermediate": ({"lidar": SECOND_CFG, "anchor_number": 2,
                             "spatial_transform": SPATIAL}, "psm"),
}


def assembly_parity(name, batch):
    args, key = ASSEMBLIES[name]
    model_cfg = {"core_method": name, "args": copy.deepcopy(args)}
    jm = jzoo.build_model(model_cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = flax_variables(jm, jb, train=False)
    pm = bridged(zoo.build_model(model_cfg), v)
    assert type(pm).__name__ == type(jm).__name__
    n_flax = sum(int(np.prod(x.shape))
                 for x in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    ref = japply(jm, v, jb, train=False)
    with torch.no_grad():
        out = pm({k: t(x) for k, x in batch.items()})
    assert set(out) == set(ref) == ({"psm", "rm"} if key == "psm"
                                    else {"cls", "reg"})
    for k in out:
        assert tuple(out[k].shape) == ref[k].shape
        close(out[k], ref[k], 1e-4)
    return pm, v


@pytest.mark.parametrize("name", sorted(ASSEMBLIES))
def test_assembly_matches_jax(lidar_batch, name):
    pm, _ = assembly_parity(name, lidar_batch)
    if name == "second_intermediate":
        assert pm.encoder_name == "SecondDetector_0"
        assert type(pm.AttFusion_0).__name__ == "AttFusion"


# -- labels and decode --------------------------------------------------------

def frame_boxes(seed):
    """A frame's lwh boxes (some overlapping, one outside the range, two
    padded rows) and their mask."""
    rng = np.random.default_rng(seed)
    n = 9
    boxes = np.concatenate([rng.uniform(-18, 18, (n, 2)),
                            rng.uniform(-1.5, -0.5, (n, 1)),
                            rng.uniform(3.5, 5.0, (n, 1)),
                            rng.uniform(1.6, 2.2, (n, 1)),
                            rng.uniform(1.4, 1.8, (n, 1)),
                            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
    boxes[1, :2] = boxes[0, :2] + 0.8  # overlaps box 0: the later one wins
    boxes[2, :2] = (25.0, 0.0)
    mask = np.ones(n, np.float32)
    mask[-2:] = 0
    return boxes.astype(np.float32), mask


@pytest.mark.parametrize("seed", [0, 1])
def test_bev_label_map_bit_for_bit(seed):
    boxes, mask = frame_boxes(seed)
    want = jpost.bev_label_map(boxes, mask, GEOMETRY)
    got = post.bev_label_map(boxes, mask, GEOMETRY)
    assert got["label_map"].shape == (7, 16, 16)
    assert np.array_equal(got["label_map"], want["label_map"])
    assert np.array_equal(got["bev_corners"], want["bev_corners"])
    assert got["label_map"][0].sum() > 0
    empty = post.bev_label_map(boxes, np.zeros_like(mask), GEOMETRY)
    assert np.array_equal(empty["label_map"], jpost.bev_label_map(
        boxes, np.zeros_like(mask), GEOMETRY)["label_map"])


def test_anchor_free_labels_for_batch_match_jax():
    from hmvit_tpu.train.trainer import labels_for_batch as jlabels
    from hmvit_tpu_torch.postprocess import build_postprocessor
    from hmvit_tpu_torch.train.trainer import labels_for_batch

    params = {"core_method": "BevPostprocessor", "geometry_param": GEOMETRY,
              "target_args": {"score_threshold": 0.5}, "nms_thresh": 0.15}
    pp = build_postprocessor(params)
    assert isinstance(pp, post.BevPostprocessor)
    assert pp.generate_anchor_box() is None
    rows = [frame_boxes(s) for s in (0, 1)]
    batch = {"object_bbx_center": np.stack([b for b, _ in rows]),
             "object_bbx_mask": np.stack([m for _, m in rows])}
    got = labels_for_batch(pp, None, batch)
    want = jlabels(jpost.BevPostprocessor(params), None, batch)
    assert set(got) == set(want) == {"label_map"}
    assert got["label_map"].dtype == torch.float32
    assert np.array_equal(got["label_map"].numpy(),
                          np.asarray(want["label_map"]))


def decode_inputs(seed):
    rng = np.random.default_rng(seed)
    cls = rng.normal(-1.0, 2.0, (1, 16, 16)).astype(np.float32)
    reg = rng.normal(0.0, 1.0, (6, 16, 16)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi)
    tf = np.eye(4, dtype=np.float32)
    tf[:2, :2] = [[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]]
    tf[:2, 3] = rng.uniform(-5, 5, 2)
    return cls, reg, tf


def kept(corners, scores, valid=None):
    """The kept boxes as rows (score, 8 corner coordinates) in score
    order: a set comparison that ignores the order of ties."""
    corners, scores = np.asarray(corners, np.float64), np.asarray(
        scores, np.float64)
    if valid is not None:
        corners, scores = corners[np.asarray(valid)], scores[np.asarray(valid)]
    rows = np.concatenate([scores[:, None], corners.reshape(len(scores), -1)],
                          1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_bev_device_matches_jax(seed):
    cls, reg, tf = decode_inputs(seed)
    want = jpost.decode_bev_device(cls, reg, tf, GEOMETRY,
                                   score_threshold=0.5, max_boxes=64)
    got = post.decode_bev_device(t(cls), t(reg), t(tf), GEOMETRY,
                                 score_threshold=0.5, max_boxes=64)
    assert tuple(got[0].shape) == want[0].shape == (64, 4, 2)
    assert int(got[2].sum()) == int(np.asarray(want[2]).sum()) > 0
    close(kept(*(g.numpy() for g in got)), kept(*want), 1e-4)


def test_bev_postprocessor_matches_jax():
    params = {"geometry_param": GEOMETRY, "nms_thresh": 0.15,
              "target_args": {"score_threshold": 0.6}}
    data, outputs = {}, {}
    for cav in range(2):
        cls, reg, tf = decode_inputs(10 + cav)
        data[cav] = {"transformation_matrix": tf}
        outputs[cav] = {"cls": cls[None], "reg": reg[None]}
    want = jpost.BevPostprocessor(params).post_process(data, outputs)
    got = post.BevPostprocessor(params).post_process(
        data, {c: {k: t(v) for k, v in o.items()}
               for c, o in outputs.items()})
    assert got[0].shape == want[0].shape and len(got[0]) > 0
    close(kept(*got), kept(*want), 1e-4)
    nothing = {c: {"cls": np.full_like(o["cls"], -20.0), "reg": o["reg"]}
               for c, o in outputs.items()}
    assert post.BevPostprocessor(params).post_process(data, nothing) == (
        None, None)


# -- one train step -----------------------------------------------------------

def test_pixor_intermediate_train_step_matches_jax(lidar_batch):
    from hmvit_tpu.train.losses import pixor_loss as jpixor_loss
    from hmvit_tpu_torch.train.losses import pixor_loss
    from hmvit_tpu_torch.train.trainer import create_train_state, \
        labels_for_batch, make_train_step
    from torch_parity import held_to_yardstick, jax_adamw_steps

    cfg = {"core_method": "pixor_intermediate",
           "args": {"lidar": PIXOR_CFG}}
    jm = jzoo.build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in lidar_batch.items()}
    variables = flax_variables(jm, jb, train=False)
    pp = post.BevPostprocessor({"geometry_param": GEOMETRY})
    # the batch's boxes are hwl: as lwh the label map still covers cells
    labels = labels_for_batch(pp, None, lidar_batch)
    assert float(labels["label_map"][:, 0].sum()) > 0
    jlab = {k: v.numpy() for k, v in labels.items()}
    ref = {x64: jax_adamw_steps(jm, variables, lidar_batch, jlab, x64,
                                1e-3, 1e-2, steps=1, loss=jpixor_loss)[0][0]
           for x64 in (True, False)}
    model = bridged(zoo.build_model(cfg), variables)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
    state = create_train_state(model, opt)
    state, parts = make_train_step(model, opt, loss_fn=pixor_loss)(
        state, {k: t(v) for k, v in lidar_batch.items()}, labels)
    grads = {n: p.grad for n, p in model.named_parameters()}

    def layout(tree):
        return flax_to_state_dict(zoo.build_model(cfg), {
            "params": tree[1], "batch_stats": tree[2]})

    (loss64, g64), (_, g32) = ((r[0], layout(r)) for r in (ref[True],
                                                           ref[False]))
    assert abs(float(parts["total_loss"]) - loss64) <= 1e-5 * abs(loss64)
    worst = held_to_yardstick(grads, g64, g32, 1e-4)
    assert worst[0] <= 1.0, worst
    # the running statistics after the step, by the same rule
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    worst = held_to_yardstick(stats, g64, g32, 1e-4, floor=1e-6)
    assert worst[0] <= 1.0, worst


# -- the tools on a PIXOR run directory ---------------------------------------

def test_lift_corners():
    from hmvit_tpu_torch.tools.inference import lift_corners

    c = np.random.default_rng(0).standard_normal((3, 4, 2))
    lifted = lift_corners(c)
    assert lifted.shape == (3, 8, 3)
    assert np.array_equal(lifted[:, :4, :2], c) and not lifted[:, :4, 2].any()
    assert np.array_equal(lifted[:, 4:, :2], c)
    assert np.all(lifted[:, 4:, 2] == 1.5)
    assert lift_corners(None) is None
    full = np.zeros((2, 8, 3))
    assert lift_corners(full) is full


def test_tools_run_a_pixor_run_directory(tmp_path):
    """``tools.train`` then ``tools.inference`` on the PIXOR corpus
    configuration shrunk to a 40.96 m range at 0.64 m (the anchor-free
    labels, the pixor loss, the BEV decode), on the CPU."""
    from hmvit_tpu_torch.config import load_config, save_config
    from hmvit_tpu_torch.tools import inference, train

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    params = load_config(os.path.join(
        repo, "hmvit_tpu_torch", "config", "hypes", "opv2v",
        "pixor_intermediate_fusion.yaml"))
    params["preprocess"]["cav_lidar_range"] = RANGE
    params["preprocess"]["args"]["res"] = 0.64
    params["preprocess"]["args"]["camera_preprocess"]["args"]["resize_x"] = 8
    params["train_params"].update(batch_size=1, max_cav=2)
    for block in (params["preprocess"], params["postprocess"],
                  params["model"]["args"]):
        block["geometry_param"] = GEOMETRY
    hypes = tmp_path / "pixor.yaml"
    save_config(params, str(hypes))
    run = str(tmp_path / "run")
    train.main(["--hypes_yaml", str(hypes), "--model_dir", run,
                "--synthetic", "--epoches", "1", "--steps_per_epoch", "2",
                "--max_points", "2048", "--cpu"])
    res = inference.main(["--model_dir", run, "--synthetic", "--max_points",
                          "2048", "--max_frames", "2", "--cpu"])
    assert set(res["iou"]) >= {"ap_30", "ap_50", "ap_70"}
    res = inference.main(["--model_dir", run, "--synthetic", "--max_points",
                          "2048", "--max_frames", "1", "--fusion_method",
                          "late", "--cpu"])
    assert "iou" in res


def test_voxelnet_corpus_anchors_miss_its_outputs():
    """A JAX package quirk the port keeps: the corpus VoxelNet hypes
    asks for anchors at feature stride 4 (128^2 over its 512^2 grid),
    but VoxelNet's RPN answers at half the grid (256^2), so its labels
    cannot meet its outputs in either package's tools (``chip_smoke.py``
    trains a copy at stride 2).  SECOND's stride 8 meets its outputs."""
    from hmvit_tpu.postprocess import build_postprocessor as jbuild
    from hmvit_tpu_torch.config import load_config
    from hmvit_tpu_torch.postprocess import build_postprocessor

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, want in (("voxelnet", (256, 128)), ("second", (64, 64))):
        params = load_config(os.path.join(
            repo, "hmvit_tpu_torch", "config", "hypes", "opv2v",
            f"{name}_intermediate_fusion.yaml"))
        jm = jzoo.build_model(params["model"])
        spec = {"points": jax.ShapeDtypeStruct((1, 5, 64, 4), jnp.float32),
                "points_mask": jax.ShapeDtypeStruct((1, 5, 64), jnp.float32),
                "agent_mask": jax.ShapeDtypeStruct((1, 5), jnp.float32),
                "mode": jax.ShapeDtypeStruct((1, 5), jnp.int32),
                "pairwise_t_matrix": jax.ShapeDtypeStruct((1, 5, 5, 4, 4),
                                                          jnp.float32)}
        out = jax.eval_shape(lambda b: jm.init_with_output(
            jax.random.key(0), b)[0], spec)
        anchors = build_postprocessor(params["postprocess"]) \
            .generate_anchor_box()
        assert np.array_equal(anchors, jbuild(
            params["postprocess"]).generate_anchor_box())
        assert (out["psm"].shape[-1], anchors.shape[0]) == want
