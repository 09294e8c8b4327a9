"""Port parity of the camera encoder zoo under HM-ViT: the image
backbones (ResNet-18/34/50 with the plain and the space-to-depth stem,
VoVNet-19/39/57), FAX, BEVFormer (the planar lift on the plain trunk
with the upsampling decoder, the deformable lift with its history),
VPN, BEVSwap with its swap attention, the bandwidth compressors, and
HMViT on the corpus's FAX and BEVFormer hetero configs shrunk to the
smoke widths.  The same weights through the bridge and the same inputs
(numpy, seeded) against the JAX package on the CPU, at the shapes of
``tests/test_camera_encoders.py`` (2 agents of 4 cameras of 64^2).
Float32: each module within 1e-5 over max(1, max |ref|); HMViT's psm
and rm within 1e-4; the space-to-depth stem within 2e-5 of the plain
stem (the JAX package's own bar).  The new encoders read nothing back
to the host in eval mode (a CUDA graph can capture them)."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import bevformer as jbevformer
from hmvit_tpu.models import layers as jlayers
from hmvit_tpu.models import resnet as jresnet
from hmvit_tpu.models import vovnet as jvovnet
from hmvit_tpu.models.fusion import swap as jswap
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.models.hmvit import make_camera_encoder as jmake
from hmvit_tpu_torch.config import load_config
from hmvit_tpu_torch.models import bev_swap, layers, resnet, vovnet
from hmvit_tpu_torch.models.fusion import swap
from hmvit_tpu_torch.models.hmvit import HMViT, make_camera_encoder
from hmvit_tpu_torch.serving import serving_hints
from test_torch_cvt import camera_inputs
from torch_parity import NoHostReads, bridged, close, flax_variables, \
    japply, no_host_copies, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_HYPES = os.path.join(REPO, "hmvit_tpu", "config", "hypes")
PORT_HYPES = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes")
N, M, IMG = 2, 4, 64
TRUNK = {"dim": 32, "out_dim": 48, "encoder_channels": [16, 16, 32, 32]}
# one camera configuration of each encoder (the JAX tests' widths)
ENCODERS = {
    "fax": dict(TRUNK, encoder="fax", bev_size=8, bev_window=4, depth=1,
                decoder_layers=1, heads=2, dim_head=16),
    "fax_grid_windows": dict(TRUNK, encoder="fax", bev_size=8, bev_window=2,
                             depth=2, decoder_layers=0, heads=2,
                             dim_head=16),
    "bevformer_plain_trunk": dict(TRUNK, encoder="bevformer", bev_size=8,
                                  num_layers=2, heads=2, decoder_layers=1,
                                  bev_range=20.0, num_cams=M),
    "bevformer_deformable": dict(TRUNK, encoder="bevformer",
                                 lift="deformable", bev_size=8,
                                 num_layers=2, heads=2, decoder_layers=1,
                                 bev_range=20.0),
    "vpn": dict(TRUNK, encoder="vpn", bev_size=8, decoder_layers=1,
                img_size=IMG),
    "vpn_ms": dict(TRUNK, encoder="vpn_ms", bev_size=4, decoder_layers=2,
                   img_size=IMG, encoder_channels=[16, 32, 32]),
    # 4^2 features resized up onto a 6^2 BEV, and 8^2 down onto 6^2 (the
    # antialiased resize): ratios that are not powers of two
    "bev_swap_up": dict(TRUNK, encoder="bev_swap", bev_size=6, window=3,
                        num_blocks=1, upsample=1, dim_head=16, num_cams=M),
    "bev_swap_down": dict(TRUNK, encoder="bev_swap", bev_size=6, window=2,
                          num_blocks=2, upsample=1, num_cams=M,
                          encoder_channels=[16, 16, 32]),
    "cvt_resnet18": dict(TRUNK, encoder="cvt", bev_size=4, num_blocks=1,
                         decoder_layers=1, backbone="resnet18", id_pick=[3]),
    "cvt_resnet34_s2d": dict(TRUNK, encoder="cvt", bev_size=4, num_blocks=1,
                             decoder_layers=1, backbone="resnet34",
                             id_pick=[2], stem_s2d=True),
    "cvt_vovnet19": dict(TRUNK, encoder="cvt", bev_size=4, num_blocks=1,
                         decoder_layers=1, backbone="vovnet-19",
                         id_pick=[3]),
    "fax_vovnet39": dict(TRUNK, encoder="fax", bev_size=4, bev_window=2,
                         depth=1, decoder_layers=1, heads=2, dim_head=16,
                         backbone="vovnet-39", id_pick=[2]),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def scaled_close(got, want, atol):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    close(got / scale, np.asarray(want) / scale, atol)


def encoder_pair(cfg, inputs, seed=0):
    """(port module, JAX output) of the camera encoder ``cfg`` on the
    same random weights."""
    jm = jmake(cfg, name=None)
    v = flax_variables(jm, *inputs, seed=seed)
    return bridged(make_camera_encoder(cfg), v), japply(jm, v, *inputs)


@pytest.mark.parametrize("name", sorted(ENCODERS))
def test_camera_encoder_matches_jax(name):
    inputs = camera_inputs(0, N, M, IMG)
    pm, ref = encoder_pair(ENCODERS[name], inputs)
    with torch.no_grad():
        out = pm(*(t(x) for x in inputs))
    assert tuple(out.shape) == ref.shape
    scaled_close(out, ref, 1e-5)


def test_deformable_lift_history_matches_jax():
    """``return_history`` and a previous frame's BEV (``prev_bev``, the
    flattened (N, Q, C) form) through every layer's temporal attention."""
    cfg = dict(ENCODERS["bevformer_deformable"], return_history=True,
               num_layers=1)
    inputs = camera_inputs(1, N, M, IMG)
    jm = jbevformer.BEVFormerEncoder(cfg)
    v = flax_variables(jm, *inputs)
    prev = np.random.default_rng(5).standard_normal(
        (N, 64, cfg["dim"])).astype(np.float32)
    ref_bev, ref_hist = jax.jit(
        lambda v, i, k, e, p: jm.apply(v, i, k, e, prev_bev=p))(
            v, *inputs, prev)
    pm = bridged(make_camera_encoder(cfg), v)
    with torch.no_grad():
        bev, hist = pm(*(t(x) for x in inputs), prev_bev=t(prev))
    scaled_close(bev, ref_bev, 1e-5)
    scaled_close(hist, ref_hist, 1e-5)


BACKBONES = [("resnet18", (1, 2, 3, 4)), ("resnet34", (3,)),
             ("resnet50", (1, 4)), ("vovnet-19", (1, 2, 3, 4)),
             ("vovnet-39", (3,)), ("vovnet-57", (4,))]


@pytest.mark.parametrize("arch,id_pick", BACKBONES,
                         ids=[a for a, _ in BACKBONES])
def test_image_backbone_matches_jax(arch, id_pick):
    x = np.random.default_rng(0).standard_normal((2, IMG, IMG, 3)).astype(
        np.float32)
    if arch.startswith("vovnet"):
        jm, pm = (jvovnet.VoVNet(arch, id_pick),
                  vovnet.VoVNet(arch, id_pick))
    else:
        jm, pm = (jresnet.ResNetEncoder(arch, id_pick),
                  resnet.ResNetEncoder(arch, id_pick))
    v = flax_variables(jm, x)
    ref = japply(jm, v, x)
    ref = ref if isinstance(ref, list) else [ref]
    with torch.no_grad():
        out = bridged(pm, v)(t(x))
    out = out if isinstance(out, list) else [out]
    assert [tuple(o.shape[1:]) for o in out] == \
        [r.shape[1:] for r in ref]
    assert [o.shape[-1] for o in out] == pm.picked_channels
    for o, r in zip(out, ref):
        scaled_close(o, r, 1e-5)


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_s2d_stem_matches_plain_stem_and_jax(arch):
    """The space-to-depth stem on the plain stem's weights: within 2e-5
    of the plain stem (the JAX package's bar, tests/test_resnet.py), and
    of the JAX package's s2d stem."""
    x = np.random.default_rng(0).standard_normal((2, IMG, IMG, 3)).astype(
        np.float32)
    jm = jresnet.ResNetEncoder(arch, (1,), stem_s2d=True)
    v = flax_variables(jm, x)
    ref = japply(jm, v, x)
    plain = bridged(resnet.ResNetEncoder(arch, (1,)), v)
    s2d = bridged(resnet.ResNetEncoder(arch, (1,), stem_s2d=True), v)
    with torch.no_grad():
        a, b = plain(t(x)), s2d(t(x))
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5, rtol=2e-5)
    scaled_close(b, ref, 1e-5)


@pytest.mark.parametrize("style", ["local", "grid"])
def test_swap_attention_matches_jax(style):
    """Three agents of an agent_size-5 table (its leading block), masked
    cells among the keys."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 8, 8, 32)).astype(np.float32)
    mask = (rng.uniform(size=(2, 3, 8, 8)) > 0.3).astype(np.float32)
    jm = jswap.SwapAttention(32, dim_head=8, window=4, style=style)
    v = flax_variables(jm, x, mask)
    ref = japply(jm, v, x, mask)
    pm = bridged(swap.SwapAttention(32, dim_head=8, window=4, style=style),
                 v)
    with torch.no_grad():
        out = pm(t(x), t(mask))
    scaled_close(out, ref, 1e-5)
    assert np.array_equal(swap.relative_position_index_3d(5, 4),
                          jswap.relative_position_index_3d(5, 4))


@pytest.mark.parametrize("hw,size", [((4, 4), (6, 6)), ((8, 8), (6, 6)),
                                     ((9, 5), (4, 7))])
def test_bilinear_resize_matches_jax(hw, size):
    x = np.random.default_rng(4).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *size, 3), "bilinear")
    close(bev_swap.resize_bilinear(t(x), size), want, 1e-5)


@pytest.mark.parametrize("kind", ["naive", "autoencoder"])
def test_compressors_match_jax(kind):
    x = np.random.default_rng(6).standard_normal((3, 8, 8, 16)).astype(
        np.float32)
    if kind == "naive":
        jm, pm = jlayers.NaiveCompressor(16, 2), layers.NaiveCompressor(16, 2)
    else:
        jm, pm = jlayers.AutoEncoder(16, 4), layers.AutoEncoder(16, 4)
    v = flax_variables(jm, x)
    with torch.no_grad():
        out = bridged(pm, v)(t(x))
    scaled_close(out, japply(jm, v, x), 1e-5)


@pytest.mark.parametrize("name", ["fax", "bevformer_deformable", "vpn",
                                  "bev_swap_down"])
def test_new_encoders_read_nothing_back(name, monkeypatch):
    """After one warm-up forward (the device constants made), the eval
    forward makes no host read and no host-to-device copy."""
    inputs = [t(x) for x in camera_inputs(2, 1, M, IMG)]
    from hmvit_tpu_torch.nn import init_parameters

    pm = init_parameters(make_camera_encoder(ENCODERS[name]), seed=0)
    with torch.no_grad():
        warm = pm(*inputs)
        with NoHostReads(), no_host_copies(monkeypatch):
            out = pm(*inputs)
    assert torch.equal(out, warm)


# the corpus's FAX and BEVFormer hetero configs at the smoke widths:
# their camera blocks with the widths of smoke_hetero_tiny.yaml's, the
# rest of the model smoke_hetero_tiny.yaml's
SHRUNK = {"dim": 32, "bev_size": 4, "out_dim": 64,
          "encoder_channels": [16, 32, 32, 32]}
CORPUS = {
    "hmvit_fax_point_pillar_hetero.yaml": dict(SHRUNK, bev_window=4,
                                               heads=2, dim_head=16),
    "bevformer_point_pillar_hetero.yaml": dict(SHRUNK, heads=2, window=4,
                                               num_layers=2, num_cams=4),
}


def shrunk_corpus_cfg(name: str, **camera) -> dict:
    smoke = load_config(os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml"))
    corpus = load_config(os.path.join(PORT_HYPES, name))
    cfg = copy.deepcopy(smoke["model"]["args"])
    cfg["camera"] = dict(corpus["model"]["args"]["camera"], **CORPUS[name],
                         **camera)
    return cfg


@pytest.fixture(scope="module")
def smoke_batch():
    from hmvit_tpu.data.synthetic import make_hetero_batch

    params = load_config(os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml"))
    batch, _ = make_hetero_batch(
        seed=3, max_cav=2, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=params["preprocess"]["cav_lidar_range"])
    batch["mode"][:, :2] = (1, 0)  # a lidar ego and a camera agent
    return batch


@pytest.mark.parametrize("name,camera,compression", [
    ("hmvit_fax_point_pillar_hetero.yaml", {}, 0),
    ("bevformer_point_pillar_hetero.yaml", {}, 0),
    ("hmvit_fax_point_pillar_hetero.yaml", {}, 2),
], ids=["fax", "bevformer", "fax_compression_2"])
def test_hmvit_shrunk_corpus_config_matches_jax(smoke_batch, name, camera,
                                                compression):
    """Run-both and the serving hints; psm and rm within 1e-4; the
    parameter count is the flax tree's, leaf for leaf."""
    cfg = dict(shrunk_corpus_cfg(name, **camera), compression=compression)
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in smoke_batch.items()}
    v = flax_variables(jm, jb, train=False)
    pm = bridged(HMViT(cfg), v)
    n_flax = sum(int(np.prod(x.shape))
                 for x in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    assert ("NaiveCompressor_0" in v["params"]) == bool(compression)
    tb = {k: t(x) for k, x in smoke_batch.items()}
    for hints in ({}, serving_hints(smoke_batch["mode"][0], 2)):
        ref = japply(jm, v, jb, train=False, **hints)
        with torch.no_grad():
            out = pm(tb, **hints)
        for key, shape in (("psm", (1, 2, 16, 16)), ("rm", (1, 14, 16, 16))):
            assert tuple(out[key].shape) == shape
            close(out[key], ref[key], 1e-4)


def test_fusion_override_still_raises():
    """The fusion overrides build (``tests/test_torch_fusion_zoo.py``
    holds them to JAX); a name the fusion registry does not know still
    raises, ValueError as in JAX's ``make_fusion``."""
    from hmvit_tpu.models.fusion import make_fusion as jmake_fusion

    cfg = dict(shrunk_corpus_cfg("hmvit_fax_point_pillar_hetero.yaml"),
               fusion_override="no_such_fusion")
    for build in (HMViT, lambda c: jmake_fusion(c["fusion_override"], 64,
                                                 {})):
        with pytest.raises(ValueError, match="unknown fusion"):
            build(cfg)
    assert HMViT(dict(cfg, fusion_override="fcooper")).fusion_override == \
        "fcooper"


@pytest.mark.parametrize("name", ["bev_swap", "vpn"])
def test_encoders_name_their_build_sizes(name):
    """The two encoders whose parameters depend on the input's extent
    (BEVSwap's view embedding: the camera count; VPN's token-axis layers:
    the image size) name it when the input does not match, and VPN
    without ``img_size``."""
    cfg = ENCODERS["bev_swap_up" if name == "bev_swap" else "vpn"]
    pm = make_camera_encoder(cfg)
    small = [t(x) for x in camera_inputs(0, 1, 2, 32)]
    with pytest.raises(ValueError, match="num_cams|img_size"):
        pm(*small)
    if name == "vpn":
        with pytest.raises(ValueError, match="img_size"):
            make_camera_encoder({k: v for k, v in cfg.items()
                                 if k != "img_size"})


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_tools_run_the_shrunk_corpus_config(name, tmp_path):
    """The run-directory tools build through ``build_model``: train (2
    steps), inference and performance on the corpus config's camera
    block at the smoke widths, under its own ``core_method``."""
    from hmvit_tpu_torch.config import save_config
    from hmvit_tpu_torch.tools import inference, performance, train

    params = load_config(os.path.join(PORT_HYPES,
                                      "smoke_hetero_tiny.yaml"))
    corpus = load_config(os.path.join(PORT_HYPES, name))
    params["model"] = {"core_method": corpus["model"]["core_method"],
                       "args": shrunk_corpus_cfg(name)}
    hypes, run = str(tmp_path / "hypes.yaml"), str(tmp_path / "run")
    save_config(params, hypes)
    losses = []
    train.main(["--hypes_yaml", hypes, "--model_dir", run, "--synthetic",
                "--epoches", "1", "--steps_per_epoch", "2", "--max_points",
                "2048", "--cpu"],
               on_step=lambda e, s, m: losses.append(float(m["total_loss"])))
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    res = inference.main(["--model_dir", run, "--synthetic", "--max_points",
                          "2048", "--cpu"])
    assert set(res["iou"]) >= {"ap_30", "ap_50", "ap_70"}
    report = performance.main(["--model_dir", run, "--synthetic", "--iters",
                               "1", "--max_points", "2048", "--cpu"])
    cfg = load_config("", model_dir=run)["model"]
    assert report["params"] == sum(
        p.numel() for p in HMViT(cfg["args"]).parameters())
