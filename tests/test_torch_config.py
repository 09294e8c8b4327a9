"""Port parity of the configuration layer: the port's ``load_config``
(its own YAML reader in hypes mode: anchors, aliases, the config floats)
against the JAX package's PyYAML loader on every shipped hypes file, the
port's copies of the hypes it builds, ``build_model`` on them and its
refusals, the ``config.yaml`` snapshot read back by both loaders, and
the port's copy of ``data/augment.py``."""
import copy
import glob
import os
import shutil

import numpy as np
import pytest
import yaml

from hmvit_tpu.config import loader as jloader
from hmvit_tpu.data import augment as jaugment
from hmvit_tpu.models import zoo as jzoo
from hmvit_tpu_torch.config import loader
from hmvit_tpu_torch.data import augment, codecs
from hmvit_tpu_torch.models import zoo
from hmvit_tpu_torch.models.hmvit import HMViT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HYPES = os.path.join(REPO, "hmvit_tpu", "config", "hypes")
PORT_HYPES = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes")
ALL_YAMLS = sorted(os.path.relpath(p, JAX_HYPES) for p in glob.glob(
    os.path.join(JAX_HYPES, "**", "*.yaml"), recursive=True))
COPIES = sorted(os.path.relpath(p, PORT_HYPES) for p in glob.glob(
    os.path.join(PORT_HYPES, "**", "*.yaml"), recursive=True))
# the corpus hypes without a model (the sequence renderer's data configs
# and the camera data-API demonstration)
MODEL_LESS = ["opcamera/base_camera.yaml", "opv2v/visualization.yaml",
              "v2xt/visualization.yaml"]
MODEL_COPIES = [name for name in COPIES if name not in MODEL_LESS]


def without_dirname(params):
    return {k: v for k, v in params.items() if k != "fileDirname"}


def builds(name: str) -> bool:
    """Whether the port builds the model of corpus hypes ``name`` (False
    for a hypes without one, or one the port refuses by name)."""
    model = loader.load_config(os.path.join(JAX_HYPES, name)).get("model")
    if model is None:
        return False
    try:
        zoo.build_model(model)
    except NotImplementedError:
        return False
    return True


def test_corpus_and_copies_present():
    assert len(ALL_YAMLS) == 83
    # the port holds a copy of every corpus hypes
    assert COPIES == ALL_YAMLS
    assert MODEL_COPIES == [
        "bevformer_point_pillar_hetero.yaml", "corpbevt.yaml",
        "cvt_nofusion.yaml", "hmvit_cvt_point_pillar_hetero.yaml",
        "hmvit_fax_point_pillar_hetero.yaml", "hmvit_prod_serving.yaml",
        "opcamera/bev_swap.yaml", "opcamera/bev_swap_static.yaml",
        "opcamera/bevt_static.yaml", "opcamera/corpbevt.yaml",
        "opcamera/corpbevt_single.yaml",
        "opcamera/corpbevt_single_static.yaml",
        "opcamera/corpbevt_static.yaml", "opcamera/cvt.yaml",
        "opcamera/cvt_att_fuse.yaml", "opcamera/cvt_att_fuse_static.yaml",
        "opcamera/cvt_disconet.yaml", "opcamera/cvt_disconet_static.yaml",
        "opcamera/cvt_fcooper.yaml", "opcamera/cvt_fcooper_static.yaml",
        "opcamera/cvt_static.yaml", "opcamera/cvt_swap_fuse.yaml",
        "opcamera/cvt_swap_fuse_static.yaml", "opcamera/cvt_v2vnet.yaml",
        "opcamera/cvt_v2vnet_static.yaml", "opcamera/fax.yaml",
        "opcamera/view_parse_network.yaml",
        "opcamera/view_parse_network_att_fuse.yaml",
        "opcamera/view_parse_network_att_fuse_static.yaml",
        "opcamera/view_parse_network_fcooper.yaml",
        "opcamera/view_parse_network_fcooper_static.yaml",
        "opcamera/view_parse_network_ms.yaml",
        "opcamera/view_parse_network_ms_static.yaml",
        "opcamera/view_parse_network_static.yaml",
        "opcamera/view_parse_network_swap_fuse.yaml",
        "opcamera/view_parse_network_swap_fuse_static.yaml",
        "opcamera/view_parse_network_v2vnet.yaml",
        "opcamera/view_parse_network_v2vnet_static.yaml",
        "opcl/bevformer_late_fusion.yaml",
        "opcl/bevformer_point_pillar_att_fuse.yaml",
        "opcl/bevformer_point_pillar_disconet.yaml",
        "opcl/bevformer_point_pillar_fax.yaml",
        "opcl/bevformer_point_pillar_hetero.yaml",
        "opcl/bevformer_point_pillar_v2vnet.yaml",
        "opcl/bevformer_point_pillar_v2xt.yaml", "opcl/corpbevt.yaml",
        "opcl/fax_att_fuse.yaml", "opcl/fax_late_fusion.yaml",
        "opcl/fax_point_pillar_att_fuse.yaml",
        "opcl/fax_point_pillar_fax.yaml",
        "opcl/fax_point_pillar_fcooper.yaml",
        "opcl/fax_point_pillar_hetero.yaml",
        "opcl/fax_point_pillar_v2vnet.yaml",
        "opcl/fax_point_pillar_v2xt.yaml",
        "opcl/lidar_point_pillar_late_fusion.yaml",
        "opcl/point_pillar_att_fuse.yaml",
        "opcl/point_pillar_cross_view_transformer_f_cooper.yaml",
        "opcl/point_pillar_late_fusion.yaml",
        "opv2v/pixor_early_fusion.yaml",
        "opv2v/pixor_intermediate_fusion.yaml",
        "opv2v/pixor_late_fusion.yaml",
        "opv2v/point_pillar_early_fusion.yaml",
        "opv2v/point_pillar_intermediate_fusion.yaml",
        "opv2v/point_pillar_late_fusion.yaml",
        "opv2v/second_early_fusion.yaml",
        "opv2v/second_intermediate_fusion.yaml",
        "opv2v/second_late_fusion.yaml",
        "opv2v/voxelnet_early_fusion.yaml",
        "opv2v/voxelnet_intermediate_fusion.yaml",
        "opv2v/voxelnet_late_fusion.yaml", "point_pillar_fcooper.yaml",
        "point_pillar_v2xt.yaml", "smoke_camera_seg_tiny.yaml",
        "smoke_hetero_tiny.yaml", "v2xt/point_pillar_early_fusion.yaml",
        "v2xt/point_pillar_fcooper.yaml",
        "v2xt/point_pillar_intermediate.yaml",
        "v2xt/point_pillar_late_fusion.yaml",
        "v2xt/point_pillar_opv2v.yaml",
        "v2xt/point_pillar_transformer.yaml"]
    # the three corpus hypes without a model
    assert [name for name in ALL_YAMLS if "model" not in
            loader.load_config(os.path.join(JAX_HYPES, name))] == MODEL_LESS
    # the port builds the model of every other corpus hypes
    assert sorted(name for name in ALL_YAMLS if builds(name)) == MODEL_COPIES


@pytest.mark.parametrize("name", ALL_YAMLS)
def test_load_config_equals_jax(name):
    """The port's load_config equals JAX's, floats exactly, the derived
    parameters included; every model core_method is one the port's
    registry knows (built or refused by name)."""
    path = os.path.join(JAX_HYPES, name)
    got = loader.load_config(path)
    assert got == jloader.load_config(path)
    method = got.get("model", {}).get("core_method")
    if method is not None:
        assert method.lower() in zoo.HETERO_NAMES | zoo.ZOO_NAMES


def test_aliases_share_the_anchored_object():
    """An alias is the anchored object itself, as in PyYAML: a parser's
    write through one reference shows at the others."""
    path = os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml")
    raw = codecs.yaml_load_file(path, hypes=True)
    want = yaml.load(open(path), Loader=jloader._Loader)
    assert raw == want
    margs = raw["model"]["args"]
    assert margs["spatial_transform"] is \
        margs["hetero_fusion"]["spatial_transform"]
    assert margs["lidar"]["voxel_size"] is \
        raw["preprocess"]["args"]["lidar_preprocess"]["args"]["voxel_size"]
    assert isinstance(raw["optimizer"]["lr"], float) and \
        raw["optimizer"]["lr"] == 2e-3


@pytest.mark.parametrize("doc,what", [
    ("a: &x {k: 1}\nb:\n  <<: *x\n", "merge"),
    ("a: !!float 1\n", "tag"),
    ("a: |\n  text\n", "block scalar"),
    ("a: >\n  text\n", "block scalar"),
    ("a: [*x]\n", "indicator"),
    ("a: *y\n", "no anchor"),
])
def test_hypes_reader_refuses_by_name(doc, what):
    with pytest.raises(codecs.YamlSubsetError, match=what):
        codecs.yaml_load(doc, hypes=True)


@pytest.mark.parametrize("text,want", [
    ("2e-4", 2e-4), ("1e-2", 1e-2), ("5e-6", 5e-6), ("1.0e5", 1e5),
    ("+3E2", 3e2), ("7", 7), ("1.5", 1.5), ("'2e-4'", "2e-4")])
def test_hypes_floats_resolve_as_the_jax_loader(text, want):
    doc = f"v: {text}\n"
    got = codecs.yaml_load(doc, hypes=True)["v"]
    assert got == yaml.load(doc, Loader=jloader._Loader)["v"] == want
    assert type(got) is type(want)


def test_unknown_parser_raises_key_error(tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text("name: x\nyaml_parser: [no_such_parser]\n")
    with pytest.raises(KeyError):
        loader.load_config(str(path))
    assert sorted(loader._PARSERS) == sorted(jloader._PARSERS)


@pytest.mark.parametrize("name", COPIES)
def test_hypes_copy_byte_equal_to_original(name):
    with open(os.path.join(PORT_HYPES, name), "rb") as f:
        mine = f.read()
    with open(os.path.join(JAX_HYPES, name), "rb") as f:
        assert mine == f.read()


def jax_param_count(model, params: dict) -> int:
    """The flax parameter count of the JAX model of a hypes (traced on
    the shapes of a synthetic batch of its fleet and image size, not
    run)."""
    import jax

    from hmvit_tpu.data.synthetic import make_hetero_batch

    cam = params["preprocess"]["args"]["camera_preprocess"]["args"]
    batch, _ = make_hetero_batch(
        seed=0, max_cav=params["train_params"]["max_cav"], num_agents=2,
        max_points=64, image_size=cam["resize_x"], num_cams=4,
        camera_ratio=0.5, ego_mode="mixed",
        lidar_range=params["preprocess"]["cav_lidar_range"])
    if type(model).__name__ == "PointPillarDetector":
        # the JAX module takes the ego's cloud alone
        batch = {k: batch[k][:, 0] for k in ("points", "points_mask")}
    spec = {k: jax.ShapeDtypeStruct(np.shape(v), np.asarray(v).dtype)
            for k, v in batch.items()}
    args = ((spec["points"], spec["points_mask"])
            if type(model).__name__ == "PointPillarDetector" else (spec,))
    shapes = jax.eval_shape(
        lambda *a: model.init(jax.random.key(0), *a, train=False), *args)
    return sum(int(np.prod(x.shape))
               for x in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("name", MODEL_COPIES)
def test_build_model_builds_each_copy(name):
    """The port builds the JAX model's class, with its parameter count;
    a new model is in eval mode; HMViT's camera encoder and fusion are
    the config's."""
    params = loader.load_config(os.path.join(PORT_HYPES, name))
    model = zoo.build_model(params["model"])
    jmodel = jzoo.build_model(params["model"])
    assert type(model).__name__ == type(jmodel).__name__
    assert not model.training
    assert sum(p.numel() for p in model.parameters()) == \
        jax_param_count(jmodel, params)
    if isinstance(model, HMViT):
        encoder = model.config["camera"].get("encoder", "cvt")
        want = {"cvt": "CrossViewTransformer",
                "bevformer": "BEVFormerEncoder", "fax": "FAXCameraEncoder"}
        assert type(model.camera_encoder).__name__ == want[encoder]
        override = jzoo._MIXED_FUSIONS.get(
            params["model"]["core_method"].lower())
        assert model.fusion_override == override


def tiny_model_args() -> dict:
    """The smoke configuration's model block, with VPN's image size and
    the BEVFormer's window for its 4^2 BEV in the camera block."""
    params = loader.load_config(os.path.join(PORT_HYPES,
                                             "smoke_hetero_tiny.yaml"))
    args = copy.deepcopy(params["model"]["args"])
    args["camera"].update(img_size=64, window=4)
    return args


# the lidar zoo's grids on the smoke range (+-20.48 m): VoxelNet's CML
# keeps one of 8 z cells, SECOND's backbone one of 24 + 1, PIXOR rasters
# 64^2 at 0.64 m
LIDAR_ZOO_GRIDS = {
    "voxel_net": {"voxel_size": [0.64, 0.64, 0.5], "grid_size": [64, 64, 8]},
    "second": {"voxel_size": [0.64, 0.64, 4.0 / 24],
               "grid_size": [64, 64, 24]},
    "pixor": {"res": 0.64},
}


def zoo_model_args(name: str) -> dict:
    """:func:`tiny_model_args`, with the lidar block of a lidar zoo name
    given its grid (``LIDAR_ZOO_GRIDS``)."""
    args = tiny_model_args()
    kind = next((k for k in LIDAR_ZOO_GRIDS if name.startswith(k)), None)
    if kind is not None:
        args["lidar"] = dict(args["lidar"], **LIDAR_ZOO_GRIDS[kind])
    return args


@pytest.mark.parametrize("name", sorted(zoo.ZOO_NAMES))
def test_build_model_refuses_the_rest_of_the_zoo(name):
    """Every other name of the JAX registry, on the smoke widths (the
    lidar zoo on its grids): the port builds the JAX model's class with
    its parameter count (nothing is refused any more)."""
    import jax
    import jax.numpy as jnp

    from hmvit_tpu.data.synthetic import make_hetero_batch

    model_cfg = {"core_method": name, "args": zoo_model_args(name)}
    jmodel = jzoo.build_model(model_cfg)
    assert name in zoo.BUILT_NAMES and name not in zoo.UNPORTED
    model = zoo.build_model(model_cfg)
    assert type(model).__name__ == type(jmodel).__name__
    batch, _ = make_hetero_batch(
        seed=0, max_cav=2, num_agents=2, max_points=64, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="mixed",
        lidar_range=[-20.48, -20.48, -3.0, 20.48, 20.48, 1.0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    args = ((jb["points"][:, 0], jb["points_mask"][:, 0])
            if name == "point_pillar" else (jb,))
    shapes = jax.eval_shape(
        lambda *a: jmodel.init(jax.random.key(0), *a, train=False), *args)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape))
        for x in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("what,model_cfg", [
    ("task: seg", {"core_method": "cvt_fcooper", "args": {"task": "seg"}}),
    ("lidar_encoder", {"core_method": "point_pillar_fcooper",
                       "args": {"lidar_encoder": "second"}}),
    ("bevformer_ref", {"core_method": "bevformer_wrapper",
                       "args": {"camera": {"encoder": "bevformer_ref"}}}),
], ids=["seg_task", "lidar_zoo_encoder", "bevformer_ref"])
def test_unported_options_of_built_names_raise(what, model_cfg):
    """What a built name may be configured with: the segmentation task
    (the BEV seg head after the fusion), the lidar zoo's encoders and the
    reference twin behind ``bevformer_wrapper`` (the standalone
    RefBEVFormerDetector) build, with the JAX model's parameter count."""
    import jax
    import jax.numpy as jnp

    from hmvit_tpu.data.synthetic import make_hetero_batch
    from hmvit_tpu_torch.models.bevformer_ref import RefBEVFormerDetector

    args = dict(zoo_model_args("second"), **model_cfg["args"])
    model_cfg = dict(model_cfg, args=args)
    model = zoo.build_model(model_cfg)
    if what == "task: seg":
        assert model.seg and not hasattr(model, "DetectionHead_0")
    elif what == "bevformer_ref":
        assert isinstance(model, RefBEVFormerDetector)
    else:
        assert model.encoder_name == "SecondDetector_0"
    batch, _ = make_hetero_batch(
        seed=0, max_cav=2, num_agents=2, max_points=64, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="mixed",
        lidar_range=[-20.48, -20.48, -3.0, 20.48, 20.48, 1.0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda b: jzoo.build_model(model_cfg).init(
        jax.random.key(0), b, train=False), jb)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape))
        for x in jax.tree_util.tree_leaves(shapes["params"]))


def test_registry_tables_covered_and_unknown_name_raises():
    for table in ("_LIDAR_FUSIONS", "_CAMERA_FUSIONS", "_VPN_FUSIONS",
                  "_MIXED_FUSIONS"):
        assert getattr(zoo, table) == getattr(jzoo, table)
    tables = (set(jzoo._LIDAR_FUSIONS) | set(jzoo._CAMERA_FUSIONS)
              | set(jzoo._VPN_FUSIONS) | set(jzoo._MIXED_FUSIONS))
    assert tables <= zoo.BUILT_NAMES
    assert zoo.ZOO_NAMES == (zoo.BUILT_NAMES - zoo.HETERO_NAMES) | set(
        zoo.UNPORTED)
    assert not zoo.BUILT_NAMES & set(zoo.UNPORTED)
    assert zoo.HETERO_NAMES == jzoo._HETERO_NAMES
    for build in (zoo.build_model, jzoo.build_model):
        with pytest.raises(ValueError, match="unknown"):
            build({"core_method": "no_such_model", "args": {}})


def test_serving_buckets_serve_a_cooperative_detector_plainly(tmp_path,
                                                              monkeypatch):
    """``tools.inference --serving_buckets --cpu`` on a CooperativeDetector
    run directory: its plain forward (no serving hints), as the JAX
    tool's dispatch serves any model but HMViT."""
    from hmvit_tpu_torch.tools import inference

    params = loader.load_config(os.path.join(PORT_HYPES,
                                             "smoke_hetero_tiny.yaml"))
    params["model"] = {"core_method": "point_pillar_fcooper",
                       "args": {k: params["model"]["args"][k] for k in
                                ("anchor_number", "lidar",
                                 "spatial_transform")}}
    run = tmp_path / "run"
    run.mkdir()
    loader.save_config(params, str(run / "config.yaml"))
    calls = []
    forward = zoo.CooperativeDetector.forward

    def spy(self, batch, **hints):
        calls.append(hints)
        return forward(self, batch, **hints)

    monkeypatch.setattr(zoo.CooperativeDetector, "forward", spy)
    res = inference.main(["--model_dir", str(run), "--synthetic",
                          "--max_points", "2048", "--max_frames", "2",
                          "--serving_buckets", "--cpu"])
    assert calls == [{}, {}]
    assert "serving" not in res and set(res["iou"]) >= {"ap_30", "ap_70"}


# the twins' camera keys over the smoke camera block: the BEVFormer twin
# at the smoke map (16^2 x 64), the FAX / CVT twins as they default
TWIN_CAMERA = {"fax_ref": {}, "cvt_ref": {},
               "bevformer_ref": {"dim": 64, "bev_h": 16, "num_layers": 1,
                                 "backbone": "resnet18"}}


@pytest.mark.parametrize("encoder", ["fax_ref", "cvt_ref", "bevformer_ref"])
def test_unported_camera_encoder_named(encoder):
    """The JAX package's reference twins build under HMViT, with the JAX
    model's parameter count."""
    import jax
    import jax.numpy as jnp

    from hmvit_tpu.data.synthetic import make_hetero_batch
    from hmvit_tpu_torch.models.hmvit import CAMERA_ENCODERS

    params = loader.load_config(os.path.join(PORT_HYPES,
                                             "smoke_hetero_tiny.yaml"))
    model_cfg = copy.deepcopy(params["model"])
    model_cfg["args"]["camera"].update(encoder=encoder,
                                       **TWIN_CAMERA[encoder])
    model = zoo.build_model(model_cfg)
    assert isinstance(model.camera_encoder, CAMERA_ENCODERS[encoder])
    batch, _ = make_hetero_batch(
        seed=0, max_cav=2, num_agents=2, max_points=64, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="mixed",
        lidar_range=params["preprocess"]["cav_lidar_range"])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(lambda b: jzoo.build_model(model_cfg).init(
        jax.random.key(0), b, train=False), jb)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(x.shape))
        for x in jax.tree_util.tree_leaves(shapes["params"]))


def test_unknown_camera_encoder_raises_value_error():
    """As the JAX package's ``make_camera_encoder`` does."""
    from hmvit_tpu.models.hmvit import make_camera_encoder

    params = loader.load_config(os.path.join(PORT_HYPES,
                                             "smoke_hetero_tiny.yaml"))
    model_cfg = copy.deepcopy(params["model"])
    model_cfg["args"]["camera"]["encoder"] = "no_such_encoder"
    with pytest.raises(ValueError, match="unknown camera encoder"):
        zoo.build_model(model_cfg)
    with pytest.raises(ValueError, match="unknown camera encoder"):
        make_camera_encoder(model_cfg["args"]["camera"])


@pytest.mark.parametrize("name", COPIES)
def test_snapshot_round_trip_in_both_loaders(name, tmp_path):
    """The port's config.yaml snapshot loads back equal in the port's and
    the JAX package's loader (as inference reads it: load_config("",
    model_dir=...)); and JAX's snapshot (PyYAML's dump, with its
    anchors) in the port's."""
    params = loader.load_config(os.path.join(PORT_HYPES, name))
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    port_dir.mkdir()
    jax_dir.mkdir()
    loader.save_config(params, str(port_dir / "config.yaml"))
    jloader.save_config(jloader.load_config(os.path.join(PORT_HYPES, name)),
                        str(jax_dir / "config.yaml"))
    want = without_dirname(params)
    for load, run in ((loader.load_config, port_dir),
                      (jloader.load_config, port_dir),
                      (loader.load_config, jax_dir)):
        back = load("", model_dir=str(run))
        assert without_dirname(back) == want
        assert back["fileDirname"] == str(run)


def test_snapshot_wins_over_the_hypes_path(tmp_path):
    src = os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml")
    shutil.copy(src, tmp_path / "config.yaml")
    other = os.path.join(PORT_HYPES, "hmvit_prod_serving.yaml")
    got = loader.load_config(other, model_dir=str(tmp_path))
    assert got["name"] == "smoke_hetero_tiny"
    assert loader.load_config(other, model_dir=str(tmp_path / "none"))[
        "name"] == "hmvit_prod_serving"


AUGMENT_QUEUES = [
    ["random_world_flip"],
    [{"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]}],
    [{"NAME": "random_world_rotation",
      "WORLD_ROT_ANGLE": [-0.78539816, 0.78539816]}],
    [{"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]}],
    ["random_world_flip", "random_world_rotation", "random_world_scaling"],
]


@pytest.mark.parametrize("queue", AUGMENT_QUEUES)
@pytest.mark.parametrize("seed", [0, 7])
def test_augment_equals_jax(queue, seed):
    rng = np.random.default_rng(100 + seed)
    points = rng.uniform(-50, 50, (512, 4)).astype(np.float32)
    boxes = rng.uniform(-5, 5, (12, 7)).astype(np.float32)
    for _ in range(3):  # the draws of later calls too
        mine = augment.DataAugmentor(queue, train=True, seed=seed)
        theirs = jaugment.DataAugmentor(queue, train=True, seed=seed)
        for (p, b), (jp, jb) in zip(
                [mine(points, boxes) for _ in range(3)],
                [theirs(points, boxes) for _ in range(3)]):
            assert np.array_equal(p, jp) and np.array_equal(b, jb)
            assert p.dtype == jp.dtype and b.dtype == jb.dtype
    # evaluation: an empty queue, the input unchanged (a copy)
    p, b = augment.DataAugmentor(queue, train=False)(points, boxes)
    assert np.array_equal(p, points) and p is not points
