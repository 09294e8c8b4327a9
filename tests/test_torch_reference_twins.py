"""Port parity of the reference twins: ``models/fax_ref.py``,
``models/cvt_ref.py``, ``models/bevformer_ref.py`` and the ResNet's
``torch_padding``.  The same weights through the bridge and the same
seeded numpy inputs against the JAX package on the CPU, float32: each
block and each encoder within 1e-5 over max(1, max |ref|), HMViT with
each twin and the standalone ``RefBEVFormerDetector`` within 1e-4 with
the flax parameter count, one HMViT train step with ``bevformer_ref``
against JAX in float64.  The reference quirks the twins transcribe are
held at batch 2, where they show.  No test needs the reference
checkout: the numpy helpers are pinned to JAX's, and the wrapper's
lidar2img formula is transcribed here as JAX's test transcribes it."""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import bevformer_ref as jbev
from hmvit_tpu.models import cvt_ref as jcvt
from hmvit_tpu.models import fax_ref as jfax
from hmvit_tpu.models import resnet as jresnet
from hmvit_tpu.models import zoo as jzoo
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.models.hmvit import make_camera_encoder as jmake
from hmvit_tpu_torch.config import load_config
from hmvit_tpu_torch.models import bevformer_ref, cvt_ref, fax_ref, resnet
from hmvit_tpu_torch.models import zoo
from hmvit_tpu_torch.models.hmvit import HMViT, make_camera_encoder
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.serving import serving_hints
from test_torch_cvt import camera_inputs
from torch_parity import NoHostReads, bridged, close, flax_variables, \
    japply, no_host_copies, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_HYPES = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes")
N, M, IMG = 2, 4, 64
SMOKE_RANGE = [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0]
# each twin's camera block at the JAX tests' widths (test_fax_ref_parity,
# test_flagship_import), 64^2 images
TWINS = {
    "fax_ref": {"encoder": "fax_ref", "backbone": "resnet18",
                "id_pick": (2, 3), "dim": 16, "bev_size": 8, "window": 4,
                "heads": 2, "dim_head": 8, "middle": [1, 1],
                "out_dim": 24, "decoder_layers": 1, "bev_range": 20.48},
    "cvt_ref": {"encoder": "cvt_ref", "backbone": "resnet18",
                "id_pick": (2, 3), "dim": 16, "bev_size": 8,
                "decoder_blocks": 1, "heads": 2, "dim_head": 8,
                "middle": [1, 1], "out_dim": 24, "decoder_layers": 1,
                "bev_range": 20.48},
    "bevformer_ref": {"encoder": "bevformer_ref", "backbone": "resnet18",
                      "dim": 32, "bev_h": 8, "bev_w": 8, "num_layers": 2,
                      "num_points_in_pillar": 4, "pc_range": SMOKE_RANGE,
                      "ffn_dim": 64, "fpn_channels": 32, "num_cams": M},
}
# the twins' camera blocks over smoke_hetero_tiny.yaml's HMViT (a 16^2 x
# 64 BEV)
HMVIT_TWINS = {
    "fax_ref": {"encoder": "fax_ref", "heads": 2, "dim_head": 16,
                "middle": [1, 1]},
    "cvt_ref": {"encoder": "cvt_ref", "heads": 2, "dim_head": 16,
                "middle": [1, 1]},
    "bevformer_ref": {"encoder": "bevformer_ref", "backbone": "resnet18",
                      "dim": 64, "bev_h": 16, "num_layers": 1,
                      "ffn_dim": 128, "fpn_channels": 64,
                      "pc_range": SMOKE_RANGE, "num_cams": M},
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def scaled_close(got, want, atol):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    close(got / scale, np.asarray(want) / scale, atol)


def calib(seed, bl, n):
    """The inverse calibration of ``camera_inputs``: (I^-1, E^-1)."""
    _, k, e = camera_inputs(seed, bl, n, IMG)
    return (np.linalg.inv(k).astype(np.float32),
            np.linalg.inv(e).astype(np.float32))


# -- the numpy helpers, pinned ------------------------------------------------

def test_numpy_helpers_equal_jax():
    for hw in ((4, 4), (5, 7)):
        assert np.array_equal(fax_ref.generate_grid(*hw),
                              jfax.generate_grid(*hw))
    args = (12, 16, 30.0, 40.0, 0.25)
    assert np.array_equal(fax_ref.get_view_matrix(*args),
                          jfax.get_view_matrix(*args))
    for got, want in zip(fax_ref.bev_grids(*args, (1, 2, 4)),
                         jfax.bev_grids(*args, (1, 2, 4))):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(cvt_ref.cvt_bev_grid(*args, 2),
                          jcvt.cvt_bev_grid(*args, 2))


@pytest.mark.parametrize("hw", [(8, 8), (16, 12)])
def test_reference_points_match_jax(hw):
    """``jnp.linspace``'s formula in float32: XLA folds the constant its
    own way, a few float32 ulps from the formula in places."""
    got3 = bevformer_ref._reference_points_3d(*hw, 4, 4.0, "cpu")
    got2 = bevformer_ref._reference_points_2d(*hw, "cpu")
    close(got3, jbev._reference_points_3d(*hw, 4, 4.0), 1e-6)
    close(got2, jbev._reference_points_2d(*hw), 1e-6)


# -- the ResNet's torch padding ----------------------------------------------

@pytest.mark.parametrize("arch,size", [("resnet18", 64), ("resnet18", 63),
                                       ("resnet50", 64), ("resnet50", 65)])
def test_torch_padding_matches_jax(arch, size):
    """PyTorch's padding grid, at even and odd sizes (the stem, the
    max-pool and the stride-2 convs); ``stem_s2d`` is ignored under it,
    as in JAX."""
    x = np.random.default_rng(0).standard_normal((2, size, size, 3)).astype(
        np.float32)
    jm = jresnet.ResNetEncoder(arch, (1, 2, 3, 4), torch_padding=True)
    v = flax_variables(jm, x)
    ref = japply(jm, v, x)
    pm = bridged(resnet.ResNetEncoder(arch, (1, 2, 3, 4), stem_s2d=True,
                                      torch_padding=True), v)
    with torch.no_grad():
        out = pm(t(x))
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        scaled_close(o, r, 1e-5)
    # the grid differs from XLA 'SAME' at even sizes
    if size % 2 == 0:
        same = bridged(resnet.ResNetEncoder(arch, (1, 2, 3, 4)), v)
        with torch.no_grad():
            assert not torch.allclose(same(t(x))[0], out[0], atol=1e-3)


# -- FAX blocks ---------------------------------------------------------------

def test_cross_win_attention_matches_jax():
    rng = np.random.default_rng(1)
    q = rng.standard_normal((2, 3, 2, 2, 4, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 3, 2, 2, 2, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 3, 2, 2, 2, 2, 16)).astype(np.float32)
    skip = rng.standard_normal((2, 2, 2, 4, 4, 16)).astype(np.float32)
    jm = jfax.RefCrossWinAttention(16, 2, 8, True)
    var = flax_variables(jm, q, k, v, skip)
    pm = bridged(fax_ref.RefCrossWinAttention(16, 2, 8, True), var)
    with torch.no_grad():
        out = pm(t(q), t(k), t(v), t(skip))
    scaled_close(out, japply(jm, var, q, k, v, skip), 1e-5)


def swap_attention_pair(flag, seed=2):
    """(port, JAX module, variables, inputs) of a CrossViewSwapAttention:
    2 x 2 cameras, an 8^2 x 16 BEV in 4^2 windows, 8^2 x 12 features."""
    rng = np.random.default_rng(seed)
    bl, n, dim, fc = 2, 2, 16, 12
    x = rng.standard_normal((bl, dim, 8, 8)).astype(np.float32)
    feature = rng.standard_normal((bl, n, fc, 8, 8)).astype(np.float32)
    i_inv, e_inv = calib(seed, bl, n)
    grid = jfax.bev_grids(8, 8, 20.0, 20.0, 0.0, (1,))[0]
    jm = jfax.RefCrossViewSwapAttention(
        feat_height=8, feat_width=8, feat_dim=fc, dim=dim, index=0,
        image_height=IMG, image_width=IMG, qkv_bias=True, q_win_size=(4, 4),
        feat_win_size=(4, 4), heads=2, dim_head=8, bev_embed_flag=flag)
    inputs = (x, jnp.asarray(grid), feature, i_inv, e_inv)
    var = flax_variables(jm, *inputs)
    pm = bridged(fax_ref.RefCrossViewSwapAttention(
        fc, dim, True, 2, 8, bev_embed_flag=flag), var)
    return pm, jm, var, (x, grid, feature, i_inv, e_inv)


@pytest.mark.parametrize("flag", [True, False], ids=["bev_embed", "plain"])
def test_cross_view_swap_attention_matches_jax(flag):
    pm, jm, var, (x, grid, feature, i_inv, e_inv) = swap_attention_pair(flag)
    ref = japply(jm, var, x, jnp.asarray(grid), feature, i_inv, e_inv)
    with torch.no_grad():
        out = pm(t(x), grid, t(feature), t(i_inv), t(e_inv), (IMG, IMG),
                 (4, 4), (4, 4))
    scaled_close(out, ref, 1e-5)


def test_attention_bottleneck_downsample_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 32, 4, 4)).astype(np.float32)
    for jm, pm in ((jfax.RefAttention(32, 16, 4),
                    fax_ref.RefAttention(32, 16, 4)),
                   (jfax.RefBottleneck(32), fax_ref.RefBottleneck(32)),
                   (jfax.RefDownsample(32, 48),
                    fax_ref.RefDownsample(32, 48))):
        var = flax_variables(jm, x)
        with torch.no_grad():
            out = bridged(pm, var)(t(x))
        scaled_close(out, japply(jm, var, x), 1e-5)


def fax_module_cfg():
    """A two-scale FAXModule: a 16^2 prior over 8^2 and 4^2 features of
    24 and 40 channels (the JAX parity test's layout)."""
    return {
        "dim": [16, 16], "middle": [1, 1],
        "backbone_output_shape": [(1, 1, 1, 24, 8, 8),
                                  (1, 1, 1, 40, 4, 4)],
        "bev_embedding": {"sigma": 1.0, "bev_height": 16, "bev_width": 16,
                          "h_meters": 40.0, "w_meters": 40.0,
                          "offset": 0.0, "upsample_scales": [1, 2]},
        "cross_view": {"image_height": IMG, "image_width": IMG,
                       "qkv_bias": True, "heads": [2, 2],
                       "dim_head": [8, 8]},
        "cross_view_swap": {"q_win_size": [[4, 4], [4, 4]],
                            "feat_win_size": [[2, 2], [2, 2]],
                            "bev_embedding_flag": [True, False]},
        "self_attn": {"dim_head": 8, "window_size": 8},
    }


def scale_features(seed, bl, n, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((bl, n, s[3], s[4], s[5])).astype(np.float32)
            for s in shapes]


def test_fax_module_matches_jax():
    cfg = fax_module_cfg()
    feats = scale_features(4, 2, 2, cfg["backbone_output_shape"])
    i_inv, e_inv = calib(4, 2, 2)
    jm = jfax.RefFAXModule(cfg)
    var = flax_variables(jm, feats, i_inv, e_inv)
    pm = bridged(fax_ref.RefFAXModule(cfg), var)
    with torch.no_grad():
        out = pm([t(f) for f in feats], t(i_inv), t(e_inv))
    scaled_close(out, japply(jm, var, feats, i_inv, e_inv), 1e-5)


# -- CVT blocks ---------------------------------------------------------------

def cvt_module_cfg():
    return {
        "dim": 16, "middle": [1, 1],
        "backbone_output_shape": [(1, 1, 1, 24, 8, 8),
                                  (1, 1, 1, 40, 4, 4)],
        "bev_embedding": {"sigma": 1.0, "bev_height": 16, "bev_width": 16,
                          "h_meters": 40.0, "w_meters": 40.0,
                          "offset": 0.0, "decoder_blocks": [0]},
        "cross_view": {"image_height": IMG, "image_width": IMG,
                       "qkv_bias": True, "heads": 2, "dim_head": 8},
    }


def test_cross_attention_matches_jax():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 3, 16, 4, 4)).astype(np.float32)
    k = rng.standard_normal((2, 3, 16, 2, 3)).astype(np.float32)
    v = rng.standard_normal((2, 3, 16, 2, 3)).astype(np.float32)
    skip = rng.standard_normal((2, 16, 4, 4)).astype(np.float32)
    jm = jcvt.RefCrossAttention(16, 2, 8, True)
    var = flax_variables(jm, q, k, v, skip)
    pm = bridged(cvt_ref.RefCrossAttention(16, 2, 8, True), var)
    with torch.no_grad():
        out = pm(t(q), t(k), t(v), t(skip))
    scaled_close(out, japply(jm, var, q, k, v, skip), 1e-5)


@pytest.mark.parametrize("no_image_features", [False, True])
def test_cross_view_attention_matches_jax(no_image_features):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 16, 8, 8)).astype(np.float32)
    feature = rng.standard_normal((2, 2, 24, 6, 6)).astype(np.float32)
    i_inv, e_inv = calib(6, 2, 2)
    grid = jcvt.cvt_bev_grid(16, 16, 40.0, 40.0, 0.0, 1)
    jm = jcvt.RefCrossViewAttention(
        feat_height=6, feat_width=6, feat_dim=24, dim=16, image_height=IMG,
        image_width=IMG, qkv_bias=True, heads=2, dim_head=8,
        no_image_features=no_image_features)
    var = flax_variables(jm, x, jnp.asarray(grid), feature, i_inv, e_inv)
    pm = bridged(cvt_ref.RefCrossViewAttention(
        24, 16, True, 2, 8, no_image_features=no_image_features), var)
    with torch.no_grad():
        out = pm(t(x), grid, t(feature), t(i_inv), t(e_inv), (IMG, IMG))
    scaled_close(out, japply(jm, var, x, jnp.asarray(grid), feature, i_inv,
                             e_inv), 1e-5)


def test_cross_view_module_matches_jax():
    cfg = cvt_module_cfg()
    feats = scale_features(7, 2, 2, cfg["backbone_output_shape"])
    i_inv, e_inv = calib(7, 2, 2)
    jm = jcvt.RefCrossViewModule(cfg)
    var = flax_variables(jm, feats, i_inv, e_inv)
    pm = bridged(cvt_ref.RefCrossViewModule(cfg), var)
    with torch.no_grad():
        out = pm([t(f) for f in feats], t(i_inv), t(e_inv))
    scaled_close(out, japply(jm, var, feats, i_inv, e_inv), 1e-5)


# -- BEVFormer blocks ---------------------------------------------------------

def wrapper_lidar2img(intrinsics, extrinsics):
    """The reference wrapper's formula with the flip's [1, 1] = -1 quirk
    (bevformer_wrapper.py:29-63), in numpy, as JAX's test writes it."""
    cav2cam = np.linalg.inv(extrinsics.astype(np.float64)).astype(
        np.float32)
    flip = np.array([[0, 1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                     [0, 0, 0, 1]], np.float32)
    flip[1, 1] = -1
    n, m = intrinsics.shape[:2]
    hom = np.tile(np.eye(4, dtype=np.float32), (n, m, 1, 1))
    hom[..., :3, :3] = intrinsics
    return hom @ (flip @ cav2cam)


def flagship_camera_inputs(rng, n, m, img_hw):
    """JAX's flagship test's cameras: looking outward at distinct yaws."""
    imgs = rng.standard_normal((n, m, *img_hw, 3)).astype(np.float32)
    intr = np.zeros((n, m, 3, 3), np.float32)
    intr[..., 0, 0] = intr[..., 1, 1] = img_hw[1] * 0.6
    intr[..., 0, 2] = img_hw[1] / 2
    intr[..., 1, 2] = img_hw[0] / 2
    intr[..., 2, 2] = 1.0
    extr = np.tile(np.eye(4, dtype=np.float32), (n, m, 1, 1))
    for j in range(m):
        a = 2 * np.pi * j / m + 0.3
        extr[:, j, 0, 0] = np.cos(a)
        extr[:, j, 0, 1] = -np.sin(a)
        extr[:, j, 1, 0] = np.sin(a)
        extr[:, j, 1, 1] = np.cos(a)
        extr[:, j, 0, 3] = 0.5 * np.cos(a)
        extr[:, j, 1, 3] = 0.5 * np.sin(a)
        extr[:, j, 2, 3] = 1.0
    return imgs, intr, extr


def test_lidar2img_matches_wrapper_formula():
    """JAX's test of the same name, by shape: the flip quirk included."""
    _, intr, extr = flagship_camera_inputs(np.random.default_rng(3), 2, 3,
                                           (64, 64))
    want = wrapper_lidar2img(intr, extr)
    got = bevformer_ref.lidar2img_ref(t(intr), t(extr))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-4)
    close(got, jbev.lidar2img_ref(jnp.asarray(intr), jnp.asarray(extr)),
          1e-5, 1e-6)


def sampling_inputs(seed, n=2, m=3, bev=8, d=4):
    """Projections of outward cameras (each batch row turned by its own
    yaw, so the rows' visibility differs) and the pillar points."""
    rng = np.random.default_rng(seed)
    _, intr, extr = flagship_camera_inputs(rng, n, m, (64, 64))
    for b in range(n):
        a = 0.7 * b
        rot = np.eye(4, dtype=np.float32)
        rot[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        extr[b] = rot @ extr[b]
    l2i = np.asarray(jbev.lidar2img_ref(jnp.asarray(intr),
                                        jnp.asarray(extr)))
    ref3d = np.asarray(jbev._reference_points_3d(bev, bev, d, 4.0))
    return l2i, ref3d


def test_point_sampling_matches_jax():
    l2i, ref3d = sampling_inputs(8)
    pc = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]
    cam, mask = bevformer_ref.point_sampling(t(ref3d), pc, t(l2i), (64, 64))
    jcam, jmask = jbev.point_sampling(jnp.asarray(ref3d), pc,
                                      jnp.asarray(l2i), (64, 64))
    assert np.array_equal(mask.numpy(), np.asarray(jmask))
    assert 0 < mask.float().mean() < 1
    # the visible points within 1e-5; behind a camera the division by
    # eps makes coordinates of 1e5 and more: relative 1e-4 there
    close(cam[mask], np.asarray(jcam)[np.asarray(jmask)], 1e-5, 1e-6)
    close(cam, jcam, 1e-5, 1e-4)


def tsa_inputs(seed, n=2, q_hw=(8, 8), c=32):
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((n, q_hw[0] * q_hw[1], c)).astype(np.float32)
    pos = rng.standard_normal((1, q_hw[0] * q_hw[1], c)).astype(np.float32)
    return query, pos


def test_temporal_self_attention_matches_jax_and_mixes_rows():
    """At batch 2 the conditioning takes ``value[:2]`` of the interleaved
    queue: [row 0, row 0].  So row 1 of the batch differs from row 1 run
    alone (a transcription without the quirk would give the same)."""
    query, pos = tsa_inputs(9)
    jm = jbev.RefTemporalSelfAttention(32, heads=4, points=4)
    var = flax_variables(jm, query, pos, bev_hw=(8, 8))
    pm = bridged(bevformer_ref.RefTemporalSelfAttention(32, 4, 4), var)
    ref = japply(jm, var, query, pos, bev_hw=(8, 8))
    with torch.no_grad():
        out = pm(t(query), t(pos), (8, 8))
        alone = pm(t(query[1:]), t(pos), (8, 8))
    scaled_close(out, ref, 1e-5)
    assert float((out[1] - alone[0]).abs().max()) > 1e-3
    with torch.no_grad():
        first = pm(t(query[:1]), t(pos), (8, 8))
    assert torch.allclose(out[0], first[0], atol=1e-6)


def sca_inputs(seed, n=2, m=3, c=32, feat_hw=(4, 4)):
    rng = np.random.default_rng(seed)
    l2i, ref3d = sampling_inputs(seed, n, m)
    pc = [-8.0, -8.0, -3.0, 8.0, 8.0, 1.0]
    ref_cam, mask = (np.asarray(a) for a in jbev.point_sampling(
        jnp.asarray(ref3d), pc, jnp.asarray(l2i), (64, 64)))
    query = rng.standard_normal((n, ref3d.shape[1], c)).astype(np.float32)
    feats = rng.standard_normal((n, m, feat_hw[0] * feat_hw[1], c)).astype(
        np.float32)
    return query, feats, ref_cam, mask


def test_spatial_cross_attention_matches_jax_and_gates_by_batch_0():
    """The contributions are gated by batch 0's visibility and
    normalised by each row's own camera count: row 1 of the batch
    differs from row 1 run alone (whose gate is its own mask)."""
    query, feats, ref_cam, mask = sca_inputs(10)
    assert not np.array_equal(mask[:, 0].any(-1), mask[:, 1].any(-1))
    jm = jbev.RefSpatialCrossAttention(32, heads=4, points=8)
    var = flax_variables(jm, query, feats, ref_cam, mask, feat_hw=(4, 4))
    pm = bridged(bevformer_ref.RefSpatialCrossAttention(32, 4, 8), var)
    ref = japply(jm, var, query, feats, ref_cam, mask, feat_hw=(4, 4))
    with torch.no_grad():
        out = pm(t(query), t(feats), t(ref_cam), t(mask), (4, 4))
        alone = pm(t(query[1:]), t(feats[1:]), t(ref_cam[:, 1:]),
                   t(mask[:, 1:]), (4, 4))
    scaled_close(out, ref, 1e-5)
    assert float((out[1] - alone[0]).abs().max()) > 1e-3


def test_bevformer_layer_matches_jax_post_norm():
    """Post-norm order: the layer equals its submodules run as norm(x +
    attention) and differs from the pre-norm order on the same weights."""
    query, feats, ref_cam, mask = sca_inputs(11)
    _, pos = tsa_inputs(11)
    args = (query, pos, feats, ref_cam, mask)
    jm = jbev.RefBEVFormerLayer(32, 64, tsa_heads=4, sca_heads=4)
    var = flax_variables(jm, *args, bev_hw=(8, 8), feat_hw=(4, 4))
    pm = bridged(bevformer_ref.RefBEVFormerLayer(32, 64, 4, 4, 4, 8), var)
    ref = japply(jm, var, *args, bev_hw=(8, 8), feat_hw=(4, 4))
    q, p, f, rc, mk = (t(a) for a in args)
    with torch.no_grad():
        out = pm(q, p, f, rc, mk, (8, 8), (4, 4))
        x = pm.norm0(pm.tsa(q, p, (8, 8)))
        x = pm.norm1(pm.sca(x, f, rc, mk, (4, 4)))
        post = pm.norm2(pm.ffn_fc2(torch.relu(pm.ffn_fc1(x))) + x)
        y = pm.tsa(pm.norm0(q), p, (8, 8))
        y = pm.sca(pm.norm1(y), f, rc, mk, (4, 4))
        pre = pm.ffn_fc2(torch.relu(pm.ffn_fc1(pm.norm2(y)))) + y
    scaled_close(out, ref, 1e-5)
    assert torch.equal(out, post)
    assert float((out - pre).abs().max()) > 1e-2


def bevformer_cfg(**kw):
    return dict(TWINS["bevformer_ref"], **kw)


@pytest.mark.parametrize("n", [1, 2])
def test_ref_bevformer_matches_jax(n):
    cfg = bevformer_cfg(num_cams=3)
    imgs, intr, extr = flagship_camera_inputs(np.random.default_rng(12), n,
                                              3, (IMG, IMG))
    jm = jbev.RefBEVFormer(cfg)
    var = flax_variables(jm, imgs, intr, extr)
    pm = bridged(bevformer_ref.RefBEVFormer(cfg), var)
    with torch.no_grad():
        out = pm(t(imgs), t(intr), t(extr))
    assert tuple(out.shape) == (n, 8, 8, 32)
    scaled_close(out, japply(jm, var, imgs, intr, extr), 1e-5)


# -- the encoders -------------------------------------------------------------

def encoder_pair(cfg, inputs, seed=0):
    jm = jmake(cfg, name=None)
    v = flax_variables(jm, *inputs, seed=seed)
    return bridged(make_camera_encoder(cfg), v), japply(jm, v, *inputs), v


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twin_encoder_matches_jax(name):
    inputs = camera_inputs(0, N, M, IMG)
    pm, ref, v = encoder_pair(TWINS[name], inputs)
    with torch.no_grad():
        out = pm(*(t(x) for x in inputs))
    assert tuple(out.shape) == ref.shape
    scaled_close(out, ref, 1e-5)
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            v["params"]))


@pytest.mark.parametrize("name", ["fax_ref", "cvt_ref"])
def test_twin_encoder_forwards(name):
    """JAX's reference-free cases (``test_fax_ref_camera_encoder_forwards``
    and the cvt one), by shape: one agent of 2 cameras of 64^2 with
    identity extrinsics, a finite (1, H', W', 24) BEV; and JAX's."""
    cfg = TWINS[name]
    rng = np.random.default_rng(6 if name == "fax_ref" else 7)
    images = rng.normal(size=(1, 2, 64, 64, 3)).astype(np.float32)
    intr = np.tile(np.eye(3, dtype=np.float32), (1, 2, 1, 1))
    intr[..., 0, 0] = intr[..., 1, 1] = 50.0
    intr[..., 0, 2] = intr[..., 1, 2] = 32.0
    extr = np.tile(np.eye(4, dtype=np.float32), (1, 2, 1, 1))
    pm, ref, _ = encoder_pair(cfg, (images, intr, extr))
    with torch.no_grad():
        out = pm(t(images), t(intr), t(extr))
    assert out.ndim == 4 and out.shape[-1] == 24
    assert torch.isfinite(out).all()
    scaled_close(out, ref, 1e-5)


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twins_read_nothing_back(name, monkeypatch):
    """After one warm-up forward (the device constants made), the eval
    forward makes no host read and no host-to-device copy."""
    inputs = [t(x) for x in camera_inputs(2, 1, M, IMG)]
    pm = init_parameters(make_camera_encoder(TWINS[name]), seed=0)
    with torch.no_grad():
        warm = pm(*inputs)
        with NoHostReads(), no_host_copies(monkeypatch):
            out = pm(*inputs)
    assert torch.equal(out, warm)


# -- HMViT with each twin; the standalone detector ----------------------------

@pytest.fixture(scope="module")
def smoke_batch():
    from hmvit_tpu.data.synthetic import make_hetero_batch

    batch, _ = make_hetero_batch(
        seed=3, max_cav=2, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=SMOKE_RANGE)
    batch["mode"][:, :2] = (1, 0)  # a lidar ego and a camera agent
    return batch


def smoke_cfg(camera: dict) -> dict:
    smoke = load_config(os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml"))
    cfg = copy.deepcopy(smoke["model"]["args"])
    cfg["camera"] = dict(cfg["camera"], **camera)
    return cfg


@pytest.mark.parametrize("name", sorted(HMVIT_TWINS))
def test_hmvit_with_twin_matches_jax(smoke_batch, name):
    """Run-both and the serving hints: psm and rm within 1e-4, the
    parameter count the flax tree's."""
    cfg = smoke_cfg(HMVIT_TWINS[name])
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in smoke_batch.items()}
    v = flax_variables(jm, jb, train=False)
    pm = bridged(HMViT(cfg), v)
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            v["params"]))
    tb = {k: t(x) for k, x in smoke_batch.items()}
    for hints in ({}, serving_hints(smoke_batch["mode"][0], 2)):
        ref = japply(jm, v, jb, train=False, **hints)
        with torch.no_grad():
            out = pm(tb, **hints)
        for key, shape in (("psm", (1, 2, 16, 16)), ("rm", (1, 14, 16, 16))):
            assert tuple(out[key].shape) == shape
            close(out[key], ref[key], 1e-4)


def wrapper_model_cfg():
    return {"core_method": "bevformer_wrapper", "args": {
        "anchor_number": 2,
        "camera": bevformer_cfg(bev_h=16, bev_w=16),
        "decoder": {"num_layer": 1, "num_ch_dec": [32]}}}


def test_bevformer_wrapper_detector_matches_jax(smoke_batch):
    """``bevformer_wrapper`` with ``encoder: bevformer_ref``: the
    standalone RefBEVFormerDetector (trunk, decoder, heads) on the ego
    slot, within 1e-4, the flax parameter count."""
    model_cfg = wrapper_model_cfg()
    pm = zoo.build_model(model_cfg)
    assert isinstance(pm, bevformer_ref.RefBEVFormerDetector)
    jm = jzoo.build_model(model_cfg)
    jb = {k: jnp.asarray(v) for k, v in smoke_batch.items()}
    v = flax_variables(jm, jb, train=False)
    pm = bridged(pm, v)
    assert sum(p.numel() for p in pm.parameters()) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
            v["params"]))
    ref = japply(jm, v, jb, train=False)
    with torch.no_grad():
        out = pm({k: t(x) for k, x in smoke_batch.items()})
    for key, shape in (("psm", (1, 2, 16, 16)), ("rm", (1, 14, 16, 16))):
        assert tuple(out[key].shape) == shape
        close(out[key], ref[key], 1e-4)


# -- one train step of HMViT with bevformer_ref -------------------------------

def test_hmvit_bevformer_ref_train_step_matches_jax(smoke_batch):
    """Gradients and loss of one AdamW step against JAX in float64
    (``held_to_yardstick``: 1e-4 of each tensor's scale, or twice JAX's
    own float32 distance where that is farther); the running statistics
    of the trunk's BatchNorms moved as JAX moves them."""
    from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
    from hmvit_tpu.train.trainer import labels_for_batch as jlabels
    from hmvit_tpu_torch.bridge import flax_to_state_dict
    from hmvit_tpu_torch.postprocess import AnchorPostprocessor
    from hmvit_tpu_torch.train.trainer import create_train_state, \
        labels_for_batch, make_train_step
    from torch_parity import held_to_yardstick, jax_adamw_steps

    smoke = load_config(os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml"))
    cfg = smoke_cfg(HMVIT_TWINS["bevformer_ref"])
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in smoke_batch.items()}
    variables = flax_variables(jm, jb, train=False)
    post = smoke["postprocess"]
    jpp = JPostprocessor(post)
    jlab = {k: np.asarray(v) for k, v in jlabels(
        jpp, jpp.generate_anchor_box(), smoke_batch).items()}
    ref = {x64: jax_adamw_steps(jm, variables, smoke_batch, jlab, x64,
                                1e-3, 1e-2, steps=1)[0][0]
           for x64 in (True, False)}
    model = bridged(HMViT(cfg), variables)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
    pp = AnchorPostprocessor(post)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), smoke_batch)
    state = create_train_state(model, opt)
    state, parts = make_train_step(model, opt)(
        state, {k: t(v) for k, v in smoke_batch.items()}, labels)
    grads = {n: p.grad for n, p in model.named_parameters()}

    def layout(tree):
        return flax_to_state_dict(HMViT(cfg), {
            "params": tree[1], "batch_stats": tree[2]})

    (loss64, g64), (_, g32) = ((r[0], layout(r)) for r in (ref[True],
                                                           ref[False]))
    assert abs(float(parts["total_loss"]) - loss64) <= 1e-5 * abs(loss64)
    worst = held_to_yardstick(grads, g64, g32, 1e-4)
    assert worst[0] <= 1.0, worst
    stats = {k: v for k, v in model.state_dict().items() if "running" in k
             and k.startswith("camera_encoder.")}
    assert stats
    worst = held_to_yardstick(stats, g64, g32, 1e-5, 1e-6)
    assert worst[0] <= 1.0, worst
