"""Port parity of the cross-view transformer camera encoder
(``hmvit_tpu_torch/models/cvt.py``) and of HMViT with it, the default
camera encoder of ``smoke_hetero_tiny.yaml``: the same weights through
the bridge, the same inputs, against the JAX package on the CPU.
Float32; the encoder within 1e-5, the model's psm / rm within 1e-4
(PERF.md §2)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models.cvt import CrossViewTransformer as JCVT
from hmvit_tpu.models.cvt import pixel_rays as jpixel_rays
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu_torch.config import load_config
from hmvit_tpu_torch.models.cvt import CrossViewTransformer, pixel_rays
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.serving import serving_hints
from torch_parity import bridged, close, flax_variables, japply, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes",
                     "smoke_hetero_tiny.yaml")
CVT_CFG = {"dim": 32, "bev_size": 4, "out_dim": 64, "num_blocks": 1,
           "decoder_layers": 2, "encoder_channels": [16, 32, 32, 32]}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def camera_inputs(seed, n=2, m=2, size=64):
    """Images, pinhole intrinsics and rigid camera-to-agent extrinsics."""
    rng = np.random.default_rng(seed)
    imgs = rng.standard_normal((n, m, size, size, 3)).astype(np.float32)
    k = np.zeros((n, m, 3, 3), np.float32)
    k[..., 0, 0] = rng.uniform(40, 80, (n, m))
    k[..., 1, 1] = rng.uniform(40, 80, (n, m))
    k[..., 0, 2] = k[..., 1, 2] = size / 2
    k[..., 2, 2] = 1.0
    e = np.tile(np.eye(4, dtype=np.float32), (n, m, 1, 1))
    yaw = rng.uniform(-np.pi, np.pi, (n, m))
    e[..., 0, 0], e[..., 0, 1] = np.cos(yaw), -np.sin(yaw)
    e[..., 1, 0], e[..., 1, 1] = np.sin(yaw), np.cos(yaw)
    e[..., :3, 3] = rng.uniform(-2, 2, (n, m, 3))
    return imgs, k, e


@pytest.mark.parametrize("hw", [(4, 4), (8, 6)])
def test_pixel_rays_match_jax(hw):
    _, k, _ = camera_inputs(1)
    got = pixel_rays(t(k), *hw, 64, 48)
    want = jpixel_rays(jnp.asarray(k), *hw, 64, 48)
    assert tuple(got.shape) == (2, 2, *hw, 3)
    close(got, want, 1e-5)


@pytest.mark.parametrize("cfg", [
    CVT_CFG,
    dict(CVT_CFG, num_blocks=2, decoder_layers=1, dim=48, bev_size=6),
    dict(CVT_CFG, backbone="resnet50", id_pick=[3], decoder_layers=0),
], ids=["smoke", "two_blocks", "resnet50"])
def test_cross_view_transformer_matches_jax(cfg):
    imgs, k, e = camera_inputs(0)
    jm = JCVT(cfg)
    v = flax_variables(jm, imgs, k, e)
    ref = japply(jm, v, imgs, k, e)
    pm = bridged(CrossViewTransformer(cfg), v)
    with torch.no_grad():
        out = pm(t(imgs), t(k), t(e))
    assert tuple(out.shape) == ref.shape
    scale = max(1.0, float(np.abs(np.asarray(ref)).max()))
    close(out / scale, np.asarray(ref) / scale, 1e-5)


def test_singular_calibration_gives_non_finite_rays_as_jax():
    """A padded slot's zero calibration: not finite in both, no raise."""
    k = np.zeros((1, 3, 3), np.float32)
    got = pixel_rays(t(k), 2, 2, 8, 8).numpy()
    want = np.asarray(jpixel_rays(jnp.asarray(k), 2, 2, 8, 8))
    assert not np.isfinite(got).all() and not np.isfinite(want).all()


@pytest.fixture(scope="module")
def smoke_model():
    """HMViT of smoke_hetero_tiny.yaml (the cvt camera branch) in both
    packages, the same weights, and a 2-agent batch of its shapes."""
    from hmvit_tpu.data.synthetic import make_hetero_batch

    torch.set_num_threads(1)
    params = load_config(SMOKE)
    cfg = params["model"]["args"]
    batch, _ = make_hetero_batch(
        seed=3, max_cav=2, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=params["preprocess"]["cav_lidar_range"])
    batch["mode"][:, :2] = (1, 0)  # a lidar ego and a camera agent
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = flax_variables(jm, jb, train=False)
    return dict(cfg=cfg, batch=batch, jb=jb, jm=jm, v=v,
                pm=bridged(HMViT(cfg), v))


@pytest.mark.parametrize("hinted", [False, True], ids=["run_both",
                                                       "serving_hints"])
def test_hmvit_smoke_config_matches_jax(smoke_model, hinted):
    f = smoke_model
    hints = serving_hints(f["batch"]["mode"][0], 2) if hinted else {}
    ref = japply(f["jm"], f["v"], f["jb"], train=False, **hints)
    with torch.no_grad():
        out = f["pm"]({k: t(v) for k, v in f["batch"].items()}, **hints)
    for key, shape in (("psm", (1, 2, 16, 16)), ("rm", (1, 14, 16, 16))):
        assert tuple(out[key].shape) == shape
        close(out[key], ref[key], 1e-4)


def test_hmvit_smoke_parameters_match_jax(smoke_model):
    """The port's parameters are the flax tree's, leaf for leaf."""
    n_flax = sum(int(np.prod(x.shape)) for x in
                 jax.tree_util.tree_leaves(smoke_model["v"]["params"]))
    assert sum(p.numel() for p in smoke_model["pm"].parameters()) == n_flax
