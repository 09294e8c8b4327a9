"""The port's checkpoint converter (``tools/convert_checkpoint.py``) and
the bridge's inverse (``state_dict_to_flax``), on the CPU, without the
reference checkout: the reference-named state_dicts come from the JAX
package's exporters (``export_flagship`` and its parts) of flax trees
drawn from a seed, or, for the FAX and CVT importers, which have no JAX
exporter, from a writer here that mirrors those importers key for key.
The port's import must equal the bridge of the same flax tree bit for
bit and JAX's import key for key; the port's export must equal JAX's
bit for bit; the CLI writes a run directory that ``tools.inference``
serves, and its reverse direction a ``.pth`` that converts back bit for
bit."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import resnet as jresnet
from hmvit_tpu.models import zoo as jzoo
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.tools import convert_checkpoint as jcc
from hmvit_tpu_torch.bridge import flax_to_state_dict, state_dict_to_flax
from hmvit_tpu_torch.config import load_config, save_config
from hmvit_tpu_torch.models import zoo
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.tools import convert_checkpoint as cc
from test_torch_reference_twins import HMVIT_TWINS, smoke_cfg
from torch_parity import flax_variables, random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_HYPES = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes")
SMOKE_RANGE = [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0]
# the flagship's camera: the BEVFormer twin at the smoke widths (a 16^2 x
# 64 BEV over 4 cameras), on ResNet-50 as the reference's
FLAGSHIP_CAMERA = dict(HMVIT_TWINS["bevformer_ref"], backbone="resnet50")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def tree_paths(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(tree_paths(v, prefix + k + "/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def assert_trees_equal(got, want):
    """Same paths, and every leaf the same dtype and bits."""
    g, w = tree_paths(got), tree_paths(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert np.array_equal(g[k], w[k]), k


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and np.array_equal(a, b), k


def numpy_tree(variables):
    return {k: jax.tree_util.tree_map(np.asarray, v)
            for k, v in variables.items()}


def save_pth(sd: dict, path: str) -> str:
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               path)
    return path


@pytest.fixture(scope="module")
def smoke_batch():
    from hmvit_tpu.data.synthetic import make_hetero_batch

    batch, _ = make_hetero_batch(
        seed=3, max_cav=2, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=SMOKE_RANGE)
    batch["mode"][:, :2] = (1, 0)
    return {k: jnp.asarray(v) for k, v in batch.items()}


def flagship_cfg():
    return smoke_cfg(FLAGSHIP_CAMERA)


@pytest.fixture(scope="module")
def flagship(smoke_batch):
    """(config, JAX-drawn flax variables of the flagship HMViT)."""
    cfg = flagship_cfg()
    variables = flax_variables(JHMViT(cfg), smoke_batch, train=False, seed=5)
    return cfg, numpy_tree(variables)


# -- the bridge's inverse -----------------------------------------------------

def shapes_of(module, *args, **kwargs):
    return jax.eval_shape(lambda *a: module.init(jax.random.key(0), *a,
                                                 **kwargs), *args)


ROUND_TRIPS = ["flagship_bevformer_ref", "hmvit_fax_ref", "hmvit_cvt_ref",
               "bevformer_wrapper_ref", "point_pillar", "production_hmvit"]


def round_trip_case(name, batch):
    """(port model, JAX variables' shapes) of one assembly."""
    if name == "flagship_bevformer_ref":
        cfg = flagship_cfg()
        return HMViT(cfg), shapes_of(JHMViT(cfg), batch, train=False)
    if name in ("hmvit_fax_ref", "hmvit_cvt_ref"):
        cfg = smoke_cfg(HMVIT_TWINS[name.split("_", 1)[1]])
        return HMViT(cfg), shapes_of(JHMViT(cfg), batch, train=False)
    if name == "bevformer_wrapper_ref":
        model_cfg = {"core_method": "bevformer_wrapper", "args": {
            "anchor_number": 2,
            "camera": dict(FLAGSHIP_CAMERA, backbone="resnet18"),
            "decoder": {"num_layer": 1, "num_ch_dec": [32]}}}
        return zoo.build_model(model_cfg), shapes_of(
            jzoo.build_model(model_cfg), batch, train=False)
    if name == "point_pillar":
        lidar = smoke_cfg({})["lidar"]
        model_cfg = {"core_method": "point_pillar", "args": lidar}
        return zoo.build_model(model_cfg), shapes_of(
            jzoo.build_model(model_cfg), batch["points"][:, 0],
            batch["points_mask"][:, 0], train=False)
    from hmvit_tpu_torch.serving import PROD_CFG, serving_config

    cfg = serving_config(PROD_CFG, bf16=False)
    return HMViT(cfg), shapes_of(JHMViT(cfg), batch, train=False)


@pytest.mark.parametrize("name", ROUND_TRIPS)
def test_state_dict_to_flax_inverts_the_bridge(name, smoke_batch):
    """state_dict_to_flax(m, flax_to_state_dict(m, tree)) == tree bit for
    bit, on a flax tree of the JAX module's structure."""
    model, shapes = round_trip_case(name, smoke_batch)
    tree = numpy_tree(random_variables(shapes, seed=1))
    sd = flax_to_state_dict(model, tree)
    assert_trees_equal(state_dict_to_flax(model, sd), tree)
    with pytest.raises(KeyError, match="missing"):
        state_dict_to_flax(model, dict(list(sd.items())[1:]))


# -- the flagship: JAX's export into the port's import, and back --------------

def flagship_margs(cfg):
    return {"lidar": cfg["lidar"], "camera": cfg["camera"],
            "hetero_decoder": cfg["hetero_decoder"]}


def test_flagship_import_equals_the_bridge_and_jax(flagship, tmp_path):
    """JAX's ``export_flagship`` of a flax tree, saved as a reference
    ``.pth``: the port's import is that tree (so its state_dict is the
    bridge's, bit for bit), JAX's import agrees key for key, with the same
    unconsumed and dead keys."""
    cfg, variables = flagship
    margs = flagship_margs(cfg)
    path = save_pth(jcc.export_flagship(variables, margs),
                    str(tmp_path / "net_epoch3.pth"))
    sd = cc.load_torch_state_dict(path)
    got = cc.convert_flagship(sd, margs)
    jsd = jcc.load_torch_state_dict(path)
    want = jcc.convert_flagship(jsd, margs)
    for key in ("params", "batch_stats"):
        assert_trees_equal(got[key], numpy_tree(want)[key])
        assert_trees_equal(got[key], variables[key])
    assert sd.unused() == jsd.unused() == []
    assert got["dead_reference_keys"] == want["dead_reference_keys"]
    assert got["camera_num_layers"] == want["camera_num_layers"] == 1
    model = HMViT(cfg)
    assert_state_dicts_equal(
        flax_to_state_dict(model, {k: got[k] for k in
                                   ("params", "batch_stats")}),
        flax_to_state_dict(model, variables))


def test_flagship_export_equals_jax(flagship):
    """The port's ``export_flagship`` equals JAX's key for key and bit for
    bit, from the flax tree and from the port model's state_dict."""
    cfg, variables = flagship
    margs = flagship_margs(cfg)
    want = jcc.export_flagship(variables, margs)
    assert_state_dicts_equal(cc.export_flagship(variables, margs), want)
    model = HMViT(cfg)
    tree = state_dict_to_flax(model, flax_to_state_dict(model, variables))
    assert_state_dicts_equal(cc.export_flagship(tree, margs), want)


def test_flagship_convert_export_convert_is_exact(flagship, tmp_path):
    """convert -> export -> convert, bit for bit: the decoder's conv bias
    refolds into the BatchNorm mean in float32 numpy, on a reference file
    whose conv biases are not zero."""
    cfg, variables = flagship
    margs = flagship_margs(cfg)
    ref = jcc.export_flagship(variables, margs)
    rng = np.random.default_rng(0)
    conv_biases = [k for k in ref if "_decoder.decoder." in k
                   and k.endswith(".bias")
                   and ref[k[:-len("bias")] + "weight"].ndim == 4]
    assert conv_biases and not any(ref[k].any() for k in conv_biases)
    for k in conv_biases:
        ref[k] = rng.standard_normal(ref[k].shape).astype(np.float32)
    path = save_pth(ref, str(tmp_path / "net_epoch1.pth"))
    r1 = cc.convert_flagship(cc.load_torch_state_dict(path), margs)
    again = save_pth(cc.export_flagship(r1, margs),
                     str(tmp_path / "net_epoch2.pth"))
    r2 = cc.convert_flagship(cc.load_torch_state_dict(again), margs)
    for key in ("params", "batch_stats"):
        assert_trees_equal(r2[key], r1[key])


# -- every other exporter into its importer -----------------------------------

def part_case(name, variables, margs):
    """(port exporter's writes, JAX exporter's writes, port importer,
    JAX importer, the subtree (params, stats)) of one part."""
    p, s = variables["params"], variables["batch_stats"]
    if name.startswith("mmdet_resnet"):
        arch = name.rsplit("_", 1)[1]
        jm = jresnet.ResNetEncoder(arch, (4,), torch_padding=True)
        v = numpy_tree(random_variables(shapes_of(
            jm, jnp.zeros((1, 64, 64, 3))), seed=2))
        sub = (v["params"], v["batch_stats"])
        return (lambda mod, w: mod.export_mmdet_resnet(w, "", *sub, arch),
                lambda mod, sd: mod.convert_mmdet_resnet(sd, arch), sub)
    if name == "bevformer_camera":
        sub = (p["camera_encoder"]["bevformer"],
               s["camera_encoder"]["bevformer"])
        return (lambda mod, w: mod.export_bevformer_camera(w, "", *sub),
                lambda mod, sd: (lambda r: (r["params"], r["batch_stats"]))(
                    mod.convert_bevformer_camera(sd)), sub)
    if name == "hetero_fusion":
        sub = (p["fusion"], {})
        return (lambda mod, w: mod.export_hetero_fusion(w, "fusion_net",
                                                        sub[0]),
                lambda mod, sd: (lambda r: (r["params"], r["batch_stats"]))(
                    mod.convert_hetero_fusion(sd)), sub)
    if name == "point_pillar_encoder":
        sub = (p["lidar_encoder"], s["lidar_encoder"])
        return (lambda mod, w: mod.export_point_pillar_encoder(
                    w, "", margs["lidar"], *sub),
                lambda mod, sd: mod.convert_point_pillar_encoder(
                    sd, margs["lidar"]), sub)
    sub = (p["HeteroDecoder_0"], s["HeteroDecoder_0"])
    return (lambda mod, w: mod.export_hetero_decoder(w, "dec", *sub, 1),
            lambda mod, sd: (lambda r: (r["params"], r["batch_stats"]))(
                mod.convert_hetero_decoder(sd.sub("dec"), 1)), sub)


PARTS = ["mmdet_resnet_resnet50", "mmdet_resnet_resnet18",
         "bevformer_camera", "hetero_fusion", "point_pillar_encoder",
         "hetero_decoder"]


@pytest.mark.parametrize("name", PARTS)
def test_part_exporters_feed_the_importers(name, flagship):
    """Each part: the port's exporter writes JAX's keys and bits; the
    port's importer of JAX's writes is the subtree again and JAX's
    importer's result, with nothing left unconsumed."""
    cfg, variables = flagship
    export, convert, sub = part_case(name, variables, flagship_margs(cfg))
    jw, pw = jcc._Writer(), cc._Writer()
    export(jcc, jw)
    export(cc, pw)
    assert_state_dicts_equal(pw.out, jw.out)
    sd, jsd = cc.StateDict(jw.out), jcc.StateDict(jw.out)
    got, want = convert(cc, sd), convert(jcc, jsd)
    for g, w, orig in zip(got, want, sub):
        assert_trees_equal(g, numpy_tree({"t": w})["t"])
        if name != "hetero_decoder":
            assert_trees_equal(g, orig)
    assert sd.unused() == jsd.unused() == []


# -- FAX and CVT: a writer in the reference's names ---------------------------

def write_fax(w, prefix, p, s):
    """The reference FAXModule keys of a RefFAXModule tree (the mirror of
    ``convert_fax_module``)."""
    w.put(f"{prefix}.bev_embedding.learned_features",
          p["bev_embedding"]["learned_features"])
    i = 0
    while f"cross_views_{i}" in p:
        base = f"{prefix}.cross_views.{i}"
        cp, cs = p[f"cross_views_{i}"], s[f"cross_views_{i}"]
        write_geometry(w, base, cp, cs)
        for a in ("cross_win_attend_1", "cross_win_attend_2"):
            write_attend(w, f"{base}.{a}", cp[a])
        for name in ("prenorm_1", "prenorm_2", "postnorm"):
            w.layernorm(f"{base}.{name}", cp[name])
        for m in ("mlp_1", "mlp_2"):
            w.linear(f"{base}.{m}.0", cp[f"{m}_fc1"])
            w.linear(f"{base}.{m}.2", cp[f"{m}_fc2"])
        write_bottlenecks(w, f"{prefix}.layers.{i}", p, s, f"layers_{i}")
        i += 1
    j = 0
    while f"downsample_layers_{j}" in p:
        base = f"{prefix}.downsample_layers.{j}.0"
        dp, ds = p[f"downsample_layers_{j}"], s[f"downsample_layers_{j}"]
        for name, idx in (("conv_pre", 0), ("conv_mid", 2),
                          ("conv_post", 5)):
            w.conv(f"{base}.{idx}", dp[name])
        for name, idx in (("bn_mid", 3), ("bn_post", 6)):
            w.batchnorm(f"{base}.{idx}", dp[name], ds[name])
        j += 1
    sa = p["self_attn"]
    w.linear(f"{prefix}.self_attn.to_qkv", sa["to_qkv"])
    w.linear(f"{prefix}.self_attn.to_out.0", sa["to_out"])
    w.put(f"{prefix}.self_attn.rel_pos_bias.weight", sa["rel_pos_bias"])


def write_geometry(w, base, cp, cs):
    for name in ("cam_embed", "img_embed", "bev_embed"):
        if name in cp:
            w.conv(f"{base}.{name}", cp[name])
    for name in ("feature_proj", "feature_linear"):
        w.conv(f"{base}.{name}.2", cp[name])
        w.batchnorm(f"{base}.{name}.0", cp[f"{name}_bn"], cs[f"{name}_bn"])


def write_attend(w, base, ap):
    for name in ("to_q", "to_k", "to_v"):
        w.layernorm(f"{base}.{name}.0", ap[f"{name}_norm"])
        w.linear(f"{base}.{name}.1", ap[name])
    w.linear(f"{base}.proj", ap["proj"])


def write_bottlenecks(w, base, p, s, key):
    j = 0
    while f"{key}_{j}" in p:
        bp, bs = p[f"{key}_{j}"], s[f"{key}_{j}"]
        for k in (1, 2, 3):
            w.conv(f"{base}.{j}.conv{k}", bp[f"conv{k}"])
            w.batchnorm(f"{base}.{j}.bn{k}", bp[f"bn{k}"], bs[f"bn{k}"])
        j += 1


def write_cvt(w, prefix, p, s):
    """The reference CrossViewModule keys of a RefCrossViewModule tree
    (the mirror of ``convert_cvt_module``)."""
    w.put(f"{prefix}.bev_embedding.learned_features",
          p["bev_embedding_learned_features"])
    i = 0
    while f"cross_views_{i}" in p:
        base = f"{prefix}.cross_views.{i}"
        cp, cs = p[f"cross_views_{i}"], s[f"cross_views_{i}"]
        write_geometry(w, base, cp, cs)
        ca, ap = f"{base}.cross_attend", cp["cross_attend"]
        write_attend(w, ca, ap)
        for name in ("prenorm", "postnorm"):
            w.layernorm(f"{ca}.{name}", ap[name])
        w.linear(f"{ca}.mlp.0", ap["mlp_fc1"])
        w.linear(f"{ca}.mlp.2", ap["mlp_fc2"])
        write_bottlenecks(w, f"{prefix}.layers.{i}", p, s, f"layers_{i}")
        i += 1


@pytest.mark.parametrize("name", ["fax", "cvt"])
def test_fax_cvt_importers_match_jax(name, smoke_batch, tmp_path):
    """A reference-named file written from the flax tree of HMViT's
    ``*_ref`` camera module: the port's import is that subtree, and JAX's
    ``convert_fax_module`` / ``convert_cvt_module`` of the same file
    agrees key for key."""
    cfg = smoke_cfg(HMVIT_TWINS[f"{name}_ref"])
    v = numpy_tree(random_variables(shapes_of(JHMViT(cfg), smoke_batch,
                                              train=False), seed=3))
    p = v["params"]["camera_encoder"][name]
    s = v["batch_stats"]["camera_encoder"][name]
    w = cc._Writer()
    prefix = "fax" if name == "fax" else "cvm"
    (write_fax if name == "fax" else write_cvt)(w, prefix, p, s)
    path = save_pth(w.out, str(tmp_path / "net_epoch2.pth"))
    sd, jsd = cc.load_torch_state_dict(path), jcc.load_torch_state_dict(path)
    got = cc.CONVERTERS[name](sd, {}, None)
    want = jcc.CONVERTERS[name](jsd, {}, None)
    for key, orig in (("params", p), ("batch_stats", s)):
        assert_trees_equal(got[key], numpy_tree(want)[key])
        assert_trees_equal(got[key], orig)
    assert sd.unused() == jsd.unused() == []


def test_find_reference_checkpoint_picks_last_epoch(tmp_path):
    for e in (1, 4, 2):
        torch.save({}, os.path.join(str(tmp_path), f"net_epoch{e}.pth"))
    assert cc.find_reference_checkpoint(str(tmp_path)).endswith(
        "net_epoch4.pth")
    path = str(tmp_path / "net_epoch2.pth")
    assert cc.find_reference_checkpoint(path) == path
    with pytest.raises(FileNotFoundError):
        cc.find_reference_checkpoint(str(tmp_path / "nothing_here"))


def test_load_torch_state_dict_unwraps_and_refuses():
    """A trainer's wrapper dict is unwrapped one level; a file without a
    dict is refused."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "wrapped.pth")
        torch.save({"state_dict": {"a.weight": torch.ones(2)}}, path)
        assert list(cc.load_torch_state_dict(path).raw) == ["a.weight"]
        torch.save([torch.ones(1)], path)
        with pytest.raises(TypeError):
            cc.load_torch_state_dict(path)


# -- the CLI: a reference run directory into one the port serves --------------

def flagship_hypes(tmp_path) -> str:
    """smoke_hetero_tiny.yaml as the flagship: ``core_method``
    bevformer_point_pillar_hetero, the camera ``encoder: bevformer_ref``
    on ResNet-18 (the run directory's config is the user's)."""
    params = load_config(os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml"))
    params["model"]["core_method"] = "bevformer_point_pillar_hetero"
    params["model"]["args"]["camera"] = dict(
        FLAGSHIP_CAMERA, backbone="resnet18")
    run = tmp_path / "run"
    run.mkdir()
    save_config(params, str(run / "config.yaml"))
    return str(run)


def test_cli_converts_a_reference_run_the_port_serves(tmp_path,
                                                      smoke_batch):
    """The port's twin of ``test_flagship_import_inference_ap_smoke``:
    JAX's export of a flax tree as a reference run's net_epoch12.pth ->
    ``convert_checkpoint --core_method bevformer_point_pillar_hetero`` ->
    the run directory's checkpoint is the bridge of that tree ->
    ``tools.inference --cpu`` serves it with finite APs.  Then the
    reverse CLI writes a .pth that converts back bit for bit."""
    from hmvit_tpu_torch.tools import inference
    from hmvit_tpu_torch.train.checkpointing import saved_model_state

    run = flagship_hypes(tmp_path)
    params = load_config("", model_dir=run)
    cfg = params["model"]["args"]
    variables = numpy_tree(random_variables(shapes_of(
        jzoo.build_model(params["model"]), smoke_batch, train=False),
        seed=7))
    ref_dir = tmp_path / "reference_run"
    ref_dir.mkdir()
    # with two of the reference's dead heads, as its files carry them
    dead = {"cls_head.weight": np.ones((2, 64, 1, 1), np.float32),
            "camera_encoder.reg_head.bias": np.ones(14, np.float32)}
    save_pth(dict(jcc.export_flagship(variables, cfg), **dead),
             str(ref_dir / "net_epoch12.pth"))
    save_pth({}, str(ref_dir / "net_epoch3.pth"))
    hypes = os.path.join(run, "config.yaml")
    report = cc.main(["--from_reference", str(ref_dir), "--core_method",
                      "bevformer_point_pillar_hetero", "--hypes", hypes,
                      "--output", os.path.join(run, "ckpt")])
    assert report["unconsumed_keys"] == []
    assert report["dead_reference_keys"] == sorted(dead)
    with open(os.path.join(run, "ckpt", "conversion_report.json")) as f:
        assert json.load(f) == report
    assert set(report) == {"converted_params", "output", "unconsumed_keys",
                           "dead_reference_keys", "camera_num_layers"}
    assert report["converted_params"] == sum(
        p.numel() for p in HMViT(cfg).parameters())
    saved = saved_model_state(os.path.join(run, "ckpt"))
    assert_state_dicts_equal(saved, flax_to_state_dict(HMViT(cfg),
                                                       variables))
    res = inference.main(["--model_dir", run, "--synthetic", "--max_frames",
                          "2", "--max_points", "2048", "--ap_mode", "iou",
                          "--cpu"])
    for k in ("ap_30", "ap_50", "ap_70"):
        assert np.isfinite(res["iou"][k]) and 0.0 <= res["iou"][k] <= 1.0
    assert res["e2e"]["fps"] > 0
    # the reverse direction
    out = str(tmp_path / "exported.pth")
    rep = cc.main(["--from_run", run, "--core_method",
                   "bevformer_point_pillar_hetero", "--to_reference", out])
    assert rep["exported_keys"] == len(jcc.export_flagship(variables, cfg))
    again = tmp_path / "again"
    cc.main(["--from_reference", out, "--core_method",
             "bevformer_point_pillar_hetero", "--hypes", hypes,
             "--output", str(again)])
    assert_state_dicts_equal(saved_model_state(str(again)), saved)


def test_cli_subtree_fills_its_module(tmp_path, smoke_batch, capsys):
    """``--core_method fax``: the FAX subtree lands in the model's one
    RefFAXModule (``camera_encoder.fax``); the rest keeps the seed-0
    initialisation, which the report counts and the CLI warns of; JAX's
    flags: --hypes is required, compression is refused."""
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.train.checkpointing import saved_model_state

    params = load_config(os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml"))
    params["model"]["args"] = smoke_cfg(HMVIT_TWINS["fax_ref"])
    hypes = str(tmp_path / "fax.yaml")
    save_config(params, hypes)
    v = numpy_tree(random_variables(shapes_of(
        JHMViT(params["model"]["args"]), smoke_batch, train=False), seed=4))
    p = v["params"]["camera_encoder"]["fax"]
    s = v["batch_stats"]["camera_encoder"]["fax"]
    w = cc._Writer()
    write_fax(w, "fax", p, s)
    path = save_pth(w.out, str(tmp_path / "net_epoch1.pth"))
    report = cc.main(["--from_reference", path, "--core_method", "fax",
                      "--hypes", hypes, "--output", str(tmp_path / "ckpt")])
    assert report["unconsumed_keys"] == []
    assert report["converted_params"] == sum(
        x.size for x in jax.tree_util.tree_leaves(p))
    assert cc.target_module(zoo.build_model(params["model"]), "fax")[0] \
        == "camera_encoder.fax."
    model = zoo.build_model(params["model"])
    total = sum(x.numel() for x in model.parameters())
    assert report["filled_module"] == "camera_encoder.fax"
    assert report["seed_initialised_params"] == (
        total - report["converted_params"]) > 0
    with open(tmp_path / "ckpt" / "conversion_report.json") as f:
        assert json.load(f) == report
    err = capsys.readouterr().err
    assert "camera_encoder.fax" in err and "seed-0" in err
    with pytest.raises(ValueError, match="not one"):
        cc.target_module(HMViT(flagship_cfg()), "fax")
    saved = saved_model_state(str(tmp_path / "ckpt"))
    fresh = init_parameters(zoo.build_model(params["model"]), 0)
    fax = flax_to_state_dict(fresh.camera_encoder.fax,
                             {"params": p, "batch_stats": s})
    want = dict(fresh.state_dict(), **{f"camera_encoder.fax.{k}": x
                                       for k, x in fax.items()})
    assert_state_dicts_equal(saved, want)
    with pytest.raises(SystemExit):
        cc.main(["--from_reference", path, "--core_method", "fax",
                 "--output", str(tmp_path / "x")])
    flag = dict(jcc.export_flagship(v_flagship_like(smoke_batch),
                                    flagship_margs(flagship_cfg())))
    flag["compressor.encoder.0.weight"] = np.zeros((1,), np.float32)
    with pytest.raises(NotImplementedError, match="compression"):
        cc.convert_flagship(cc.StateDict(flag),
                            flagship_margs(flagship_cfg()))


def v_flagship_like(batch):
    return numpy_tree(random_variables(shapes_of(
        JHMViT(flagship_cfg()), batch, train=False), seed=6))


def test_unknown_core_method_and_missing_key_are_named():
    with pytest.raises(ValueError, match="unsupported core_method"):
        cc.convert("nowhere.pth", "no_such_method")
    with pytest.raises(KeyError, match="missing"):
        cc.StateDict({}).take("conv1.weight")


def test_converter_tables_equal_jax():
    """The port's copy keeps JAX's conversions, dead keys and layouts."""
    assert sorted(cc.CONVERTERS) == sorted(jcc.CONVERTERS)
    assert cc._FLAGSHIP_DEAD == jcc._FLAGSHIP_DEAD
    assert cc._RESNET_LAYOUT == jcc._RESNET_LAYOUT
    assert cc._RESNET_BOTTLENECK == jcc._RESNET_BOTTLENECK
