"""Port parity: the two per-agent encoders of the flagship vs their flax
modules — PointPillars lidar (pillarize with its stable-sort point cap
and without it, PFN, max scatter by every route, BEV backbone with whole
and fractional upsample strides, shrink head, the lidar-only detector),
ResNet-50 + FPN with XLA 'SAME' padding and BatchNorm eps 1e-5, and the
planar-lift BEVFormer.  Float32; 1e-5 absolute for the lidar path, 1e-4
through the 50-layer ResNet and the camera encoder (deeper fp32 sums)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import bevformer as jbf
from hmvit_tpu.models.pillar_encoder import BEVBackbone as JBEVBackbone
from hmvit_tpu.models.pillar_encoder import PointPillarEncoder as JPPE
from hmvit_tpu.models.point_pillar import PointPillarDetector as JPPD
from hmvit_tpu.models.resnet import FPN as JFPN
from hmvit_tpu.models.resnet import ResNetEncoder as JResNet
from hmvit_tpu.ops import voxelize as jvox
from hmvit_tpu_torch.models import bevformer as pbf
from hmvit_tpu_torch.models.pillar_encoder import (
    BEVBackbone,
    PointPillarEncoder,
)
from hmvit_tpu_torch.models.point_pillar import PointPillarDetector
from hmvit_tpu_torch.models.resnet import FPN, ResNetEncoder
from hmvit_tpu_torch.ops import voxelize as pvox
from tiny_cfg import TINY_CFG
from torch_parity import TINY_CAMERA, bridged, close, flax_variables, \
    japply, t, tiny_batch


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _points(seed=0):
    batch, _ = tiny_batch(seed)
    return batch["points"][0, :3], batch["points_mask"][0, :3]


def test_pillarize_stable_cap():
    """Dense pillars over the cap: the kept points must be the first
    max_points_per_pillar in input order (stable sort)."""
    rng = np.random.default_rng(0)
    pts = np.zeros((2, 300, 4), np.float32)
    pts[..., :2] = rng.uniform(-1.0, 1.0, (2, 300, 2))  # few pillars
    pts[..., 3] = rng.uniform(size=(2, 300))
    mask = np.ones((2, 300), np.float32)
    mask[1, 250:] = 0.0
    args = ((0.64, 0.64, 4.0), (-20.48, -20.48, -3.0, 20.48, 20.48, 1.0),
            (64, 64))
    want = jvox.pillarize(jnp.asarray(pts), jnp.asarray(mask), *args, 8)
    got = pvox.pillarize(t(pts), t(mask), *args, 8)
    for key in ("pillar_id", "keep"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    for key in ("points", "mean_xyz", "center_offset", "count_per_point"):
        close(got[key], want[key], 1e-5)


def _cloud(seed=7, nz=1):
    """Two clouds of 500 points over a 12.8 m square, a tenth masked."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6.3, 6.3, size=(2, 500, 4)).astype(np.float32)
    pts[..., 2] = rng.uniform(-2.9, 0.9, (2, 500))
    pts[..., 3] = rng.random((2, 500))
    mask = (rng.random((2, 500)) > 0.1).astype(np.float32)
    grid = (32, 32) if nz == 1 else (32, 32, nz)
    args = ((0.4, 0.4, 4.0 / nz), (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0), grid)
    return pts, mask, args, grid


@pytest.mark.parametrize("nz", [1, 2])
def test_pillarize_cap_free(nz):
    """``enforce_cap=False``: no sort, every in-range point kept, sums by
    ``index_add_`` (deterministic on the CPU)."""
    pts, mask, args, _ = _cloud(nz=nz)
    want = jvox.pillarize(jnp.asarray(pts), jnp.asarray(mask), *args, 8,
                          enforce_cap=False)
    got = pvox.pillarize(t(pts), t(mask), *args, 8, enforce_cap=False)
    for key in ("pillar_id", "keep"):
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert np.array_equal(got["points"].numpy(), pts.reshape(-1, 4))
    assert int(got["keep"].sum()) > 800
    for key in ("mean_xyz", "center_offset", "count_per_point"):
        close(got[key], want[key], 1e-5)


SCATTER_ROUTES = {
    "unsorted": dict(sorted_ids=False),
    "scan_gather": dict(max_run=8),
    "scan_kernel": dict(max_run=8, use_scan_kernel=True),
    "expand_v1": dict(max_run=8, use_expand_kernel=True),
    "expand_v2": dict(max_run=8, use_expand_kernel="v2"),
    "scan_kernel_expand_v2": dict(max_run=8, use_scan_kernel=True,
                                  use_expand_kernel="v2"),
}


@pytest.mark.parametrize("nz", [1, 2])
@pytest.mark.parametrize("route", sorted(SCATTER_ROUTES))
def test_scatter_max_to_bev_routes(route, nz):
    """Every route of the dense-grid build against the JAX function (on
    the CPU its non-TPU routes: log-shift scan, oracle expansion), and
    against a segment maximum computed with numpy."""
    kwargs = SCATTER_ROUTES[route]
    cap = kwargs.get("sorted_ids", True)
    pts, mask, args, grid = _cloud(nz=nz)
    jinfo = jvox.pillarize(jnp.asarray(pts), jnp.asarray(mask), *args, 8,
                           enforce_cap=cap)
    info = pvox.pillarize(t(pts), t(mask), *args, 8, enforce_cap=cap)
    feats = np.random.default_rng(1).normal(size=(1000, 16)).astype(
        np.float32)
    want = jvox.scatter_max_to_bev(jnp.asarray(feats), jinfo["pillar_id"],
                                   jinfo["keep"], grid, 2, **kwargs)
    got = pvox.scatter_max_to_bev(t(feats), info["pillar_id"], info["keep"],
                                  grid, 2, **kwargs)
    assert got.shape == want.shape == ((2, 32, 32, 16) if nz == 1
                                       else (2, 2, 32, 32, 16))
    close(got, want, 1e-5)
    pid, keep = info["pillar_id"].numpy(), info["keep"].numpy()
    dense = np.zeros((2 * 32 * 32 * nz, 16), np.float32)
    for cell in np.unique(pid[keep]):
        dense[cell] = feats[keep & (pid == cell)].max(axis=0)
    assert np.array_equal(got.numpy().reshape(dense.shape), dense)


def test_compaction_has_a_static_shape():
    """One row per non-empty pillar in cell order, then fill rows whose id
    is the number of cells: P rows whatever the data."""
    pts, mask, args, _ = _cloud()
    info = pvox.pillarize(t(pts), t(mask), *args, 8)
    keep, pid = info["keep"], info["pillar_id"]
    pid2 = torch.where(keep, pid, -1)
    rows = torch.arange(1000, dtype=torch.float32)[:, None].repeat(1, 8)
    comp, ids = pvox.compact_pillar_rows(rows, pid, pid2, keep, 2048)
    assert comp.shape == (1000, 8) and ids.shape == (1000,)
    assert ids.dtype == torch.int32
    cells = np.unique(pid.numpy()[keep.numpy()])
    assert np.array_equal(ids.numpy()[:len(cells)], cells)
    assert np.all(ids.numpy()[len(cells):] == 2048)
    last = [int(np.flatnonzero(keep.numpy() & (pid.numpy() == c))[-1])
            for c in cells]
    assert np.array_equal(comp.numpy()[:len(cells), 0], last)


LIDAR_VARIANTS = {
    "default": {},
    "cap_free": {"enforce_point_cap": False},
    "expand_v1": {"scatter_variant": True},
    "expand_v2": {"scatter_variant": "v2"},
    "cap_free_two_layer_pfn": {"enforce_point_cap": False,
                               "num_filters": [16, 32]},
    "two_layer_pfn": {"num_filters": [16, 32]},
}


def _lidar_cfg(variant):
    cfg = copy.deepcopy(TINY_CFG["lidar"])
    for key, value in LIDAR_VARIANTS[variant].items():
        if key == "scatter_variant":
            cfg[key] = value
        else:
            cfg["pillar_vfe"][key] = value
    return cfg


@pytest.mark.parametrize("variant", sorted(LIDAR_VARIANTS))
def test_lidar_encoder_variants(variant):
    """``pillar_vfe.enforce_point_cap: false`` and
    ``scatter_variant`` (v1, v2) through the whole encoder."""
    cfg = _lidar_cfg(variant)
    pts, pmask = _points()
    jm = JPPE(cfg)
    v = flax_variables(jm, pts, pmask)
    pm = bridged(PointPillarEncoder(cfg), v)
    pfn = pm.PillarFeatureNet_0
    assert pfn.enforce_cap == ("cap_free" not in variant)
    assert pfn.scatter_variant == cfg.get("scatter_variant", False)
    with torch.no_grad():
        got = pm(t(pts), t(pmask))
    want = japply(jm, v, pts, pmask)
    assert got.shape == want.shape == (3, 16, 16, 64)
    close(got, want, 1e-5)


def test_bev_backbone_fractional_upsample_stride():
    """An upsample stride under 1 is a strided convolution named by
    flax's per-class count: Conv_0 beside ConvTranspose_0 / _1."""
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 8)).astype(
        np.float32)
    args = dict(layer_nums=[1, 1, 1], layer_strides=[1, 2, 2],
                num_filters=[8, 16, 16], upsample_strides=[0.5, 1, 2])
    jm = JBEVBackbone(num_upsample_filters=[8, 8, 8], **args)
    v = flax_variables(jm, x)
    assert sorted(k for k in v["params"] if k.startswith("Conv")) == [
        "ConvBNReLU_0", "ConvBNReLU_1", "ConvBNReLU_2", "ConvBNReLU_3",
        "ConvBNReLU_4", "ConvBNReLU_5", "ConvTranspose_0",
        "ConvTranspose_1", "Conv_0"]
    pm = bridged(BEVBackbone(8, num_upsample_filters=[8, 8, 8], **args), v)
    with torch.no_grad():
        got = pm(t(x))
    want = japply(jm, v, x)
    assert got.shape == want.shape == (2, 16, 16, 24)
    close(got, want, 1e-5)


@pytest.mark.parametrize("return_features", [False, True])
def test_point_pillar_detector(return_features):
    cfg = TINY_CFG["lidar"]
    pts, pmask = _points()
    jm = JPPD(cfg, return_features=return_features)
    v = flax_variables(jm, pts, pmask)
    pm = bridged(PointPillarDetector(cfg, return_features), v)
    with torch.no_grad():
        got = pm(t(pts), t(pmask))
    want = japply(jm, v, pts, pmask)
    if return_features:
        assert got.shape == (3, 16, 16, 64)
        close(got, want, 1e-5)
        return
    for key, shape in (("psm", (3, 2, 16, 16)), ("rm", (3, 14, 16, 16))):
        assert tuple(got[key].shape) == shape
        close(got[key], want[key], 1e-5)


def test_lidar_encoder():
    cfg = TINY_CFG["lidar"]
    pts, pmask = _points()
    jm = JPPE(cfg)
    v = flax_variables(jm, pts, pmask)
    pm = bridged(PointPillarEncoder(cfg), v)
    with torch.no_grad():
        got = pm(t(pts), t(pmask))
    want = japply(jm, v, pts, pmask)
    assert got.shape == want.shape == (3, 16, 16, 64)
    close(got, want, 1e-5)


def test_resnet50_fpn():
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(
        np.float32)
    jr = JResNet(arch="resnet50", id_pick=(2, 3, 4))
    vr = flax_variables(jr, x)
    pr = bridged(ResNetEncoder("resnet50", (2, 3, 4)), vr)
    with torch.no_grad():
        feats = pr(t(x))
    want = japply(jr, vr, x)
    assert [tuple(f.shape) for f in feats] == [(2, 8, 8, 512),
                                                (2, 4, 4, 1024),
                                                (2, 2, 2, 2048)]
    for g, w in zip(feats, want):
        close(g, w, 1e-4, 1e-4)
    jf = JFPN(out_channels=16)
    vf = flax_variables(jf, want)
    pf = bridged(FPN([512, 1024, 2048], 16), vf)
    with torch.no_grad():
        outs = pf([t(np.asarray(w)) for w in want])
    for g, w in zip(outs, japply(jf, vf, want)):
        close(g, w, 1e-4, 1e-4)


def test_planar_bevformer():
    cfg = copy.deepcopy(TINY_CAMERA)
    batch, _ = tiny_batch(0)
    cams = batch["camera"][0, :2]
    intr, extr = batch["intrinsics"][0, :2], batch["extrinsics"][0, :2]
    close(pbf.lidar2img(t(intr), t(extr)), jbf.lidar2img(intr, extr), 1e-4)
    jm = jbf.BEVFormerEncoder(cfg)
    v = flax_variables(jm, cams, intr, extr, train=False)
    pm = bridged(pbf.BEVFormerEncoder(cfg), v)
    with torch.no_grad():
        got = pm(t(cams), t(intr), t(extr))
    want = japply(jm, v, cams, intr, extr, train=False)
    assert got.shape == want.shape == (2, 16, 16, 64)
    close(got, want, 1e-4, 1e-4)
