"""Port parity: the two per-agent encoders of the flagship vs their flax
modules — PointPillars lidar (pillarize with its stable-sort point cap,
PFN, max scatter, BEV backbone, shrink head), ResNet-50 + FPN with XLA
'SAME' padding and BatchNorm eps 1e-5, and the planar-lift BEVFormer.
Float32; 1e-5 absolute for the lidar path, 1e-4 through the 50-layer
ResNet and the camera encoder (deeper fp32 sums)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import bevformer as jbf
from hmvit_tpu.models.pillar_encoder import PointPillarEncoder as JPPE
from hmvit_tpu.models.resnet import FPN as JFPN
from hmvit_tpu.models.resnet import ResNetEncoder as JResNet
from hmvit_tpu.ops import voxelize as jvox
from hmvit_tpu_torch.models import bevformer as pbf
from hmvit_tpu_torch.models.pillar_encoder import PointPillarEncoder
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
