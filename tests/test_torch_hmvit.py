"""Port parity for the whole serving path: HMViT (lidar PointPillars +
planar BEVFormer on ResNet-50/FPN, 2 H3GAT iterations, per-modality
decoder) on a 4-agent mixed fleet with the serving hints of bench.py,
then anchor decode and rotated NMS — against the JAX package on the
CPU.  Float32; psm/rm within 1e-4 absolute (a 50-layer trunk and two
fusion iterations of float32 sums); decoded boxes within 1e-3 m, kept
box SETS equal (top-k and NMS may order equal scores differently).

The ``use_fused_wa`` model is held to JAX at a 64^2 BEV map, the
smallest the fused route's shape rule admits.  A batch of two fleets
equals each fleet's batch-1 forward and the JAX package's batch-2
forward.

Also: neither the port nor chip_smoke.py imports jax or flax, and
chip_smoke.py refuses to run (and prints no result) without a CUDA
device."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.data.anchors import generate_anchor_grid
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.postprocess import decode_detections_device as jdecode
from hmvit_tpu_torch.bridge import flax_to_state_dict
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.postprocess import decode_detections_device
from hmvit_tpu_torch.serving import request_batch, serving_hints
from hmvit_tpu_torch.utils.precision import strict_fp32
from tiny_cfg import ANCHOR_ARGS, RANGE
from torch_parity import bridged, close, flax_variables, japply, t, \
    tiny_batch, tiny_flagship_cfg, widened_bf16_einsum

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    """One JAX reference run shared by the tests of this module."""
    torch.set_num_threads(1)
    cfg = tiny_flagship_cfg()
    batch, _ = tiny_batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    modes = tuple(int(m) for m in batch["mode"][0, :4])
    hints = dict(camera_bucket=int(sum(m == 0 for m in modes)),
                 active_agents=4, static_ego_modality=modes[0],
                 static_modes=modes)
    jm = JHMViT(cfg)
    v = flax_variables(jm, jb, train=False)
    ref = japply(jm, v, jb, train=False, **hints)
    anchors = generate_anchor_grid(ANCHOR_ARGS, "hwl")
    jdet = jdecode(ref["psm"], ref["rm"], jnp.asarray(anchors),
                   jnp.eye(4))
    pm = bridged(HMViT(cfg), v)
    return dict(cfg=cfg, batch=batch, hints=hints, variables=v, ref=ref,
                anchors=anchors, jdet=jdet, model=pm)


def _port_forward(f, **hints):
    tb = {k: t(v) for k, v in f["batch"].items()}
    with torch.no_grad():
        return f["model"](tb, **hints)


def test_hmvit_serving_hints_match_jax(flagship):
    out = _port_forward(flagship, **flagship["hints"])
    for key, shape in (("psm", (1, 2, 16, 16)), ("rm", (1, 14, 16, 16))):
        assert tuple(out[key].shape) == shape
        close(out[key], flagship["ref"][key], 1e-4)


@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_hmvit_scatter_variant_matches_jax(flagship, variant):
    """``lidar.scatter_variant``: the lidar encoder's dense grid through
    compaction + an expansion function (its plain version here; the flax
    model takes its oracle off a TPU).  1e-4 against JAX as above, and
    bit for bit against the port's default route: the grid is the same
    tensor."""
    import copy

    from hmvit_tpu_torch.ops import expand as pexpand
    from hmvit_tpu_torch.serving import serving_config

    cfg = copy.deepcopy(flagship["cfg"])
    cfg["lidar"]["scatter_variant"] = variant
    served = serving_config(flagship["cfg"], bf16=False, expand=variant)
    assert served["lidar"]["scatter_variant"] == variant
    assert "scatter_variant" not in flagship["cfg"]["lidar"]
    jb = {k: jnp.asarray(v) for k, v in flagship["batch"].items()}
    ref = japply(JHMViT(cfg), flagship["variables"], jb, train=False,
                 **flagship["hints"])
    pm = bridged(HMViT(cfg), flagship["variables"])
    calls = []
    name = ("expand_rows_to_dense_v2" if variant == "v2"
            else "expand_rows_to_dense")
    fn = getattr(pexpand, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pexpand, name,
                   lambda *a: calls.append(a[2]) or fn(*a))
        with torch.no_grad():
            out = pm({k: t(v) for k, v in flagship["batch"].items()},
                     **flagship["hints"])
    assert calls == [2 * 64 * 64]  # one grid for the two lidar agents
    default = _port_forward(flagship, **flagship["hints"])
    for key in ("psm", "rm"):
        close(out[key], ref[key], 1e-4)
        assert torch.equal(out[key], default[key])


def test_serving_config_rejects_unknown_expand():
    from hmvit_tpu_torch.serving import PROD_CFG, serving_config

    with pytest.raises(ValueError):
        serving_config(PROD_CFG, bf16=True, expand="v3")
    assert "scatter_variant" not in serving_config(
        PROD_CFG, bf16=True)["lidar"]


def test_run_both_equals_serving_buckets(flagship):
    bucketed = _port_forward(flagship, **flagship["hints"])
    run_both = _port_forward(flagship, active_agents=4)
    for key in ("psm", "rm"):
        close(run_both[key], bucketed[key].numpy(), 1e-5)


def test_hmvit_use_fused_wa_matches_jax(monkeypatch):
    """The whole model with ``use_fused_wa: True`` on a 64^2 map (256^2
    pillar grid, 64^2 BEVFormer): the port's local phases go through the
    fused warp + attention wrapper (its plain twin here), the flax model
    through its CPU route.  1e-4, as the test above."""
    from hmvit_tpu_torch.models import hetero_fusion as phf

    cfg = tiny_flagship_cfg()
    cfg["lidar"]["voxel_size"] = [0.16, 0.16, 4.0]
    cfg["lidar"]["point_pillar_scatter"]["grid_size"] = [256, 256, 1]
    cfg["camera"]["bev_size"] = 64
    blk = cfg["hetero_fusion"]["hetero_fusion_block"]
    blk["spatial_transform"]["voxel_size"] = [0.16, 0.16, 4]
    blk["use_fused_wa"] = True
    batch, _ = tiny_batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    modes = tuple(int(m) for m in batch["mode"][0, :4])
    hints = dict(camera_bucket=int(sum(m == 0 for m in modes)),
                 active_agents=4, static_ego_modality=modes[0],
                 static_modes=modes)
    jm = JHMViT(cfg)
    v = flax_variables(jm, jb, train=False)
    ref = japply(jm, v, jb, train=False, **hints)
    pm = bridged(HMViT(cfg), v)
    fused_calls = []
    fused = phf.fused_warp_window_attention
    monkeypatch.setattr(
        phf, "fused_warp_window_attention",
        lambda *a, **k: fused_calls.append(a[0].shape) or fused(*a, **k))
    with torch.no_grad():
        out = pm({k: t(v_) for k, v_ in batch.items()}, **hints)
    # the two local phases, each over all 4 receivers (a sequential
    # block restricts only its grid phase to the ego)
    assert fused_calls == [(4, 64, 64, 64)] * 2
    for key, shape in (("psm", (1, 2, 64, 64)), ("rm", (1, 14, 64, 64))):
        assert tuple(out[key].shape) == shape
        close(out[key], ref[key], 1e-4)


def _kept(corners, scores, valid):
    corners, scores = np.asarray(corners), np.asarray(scores)
    valid = np.asarray(valid)
    centers = corners[valid].mean(axis=1)
    order = np.lexsort((centers[:, 1].round(2), centers[:, 0].round(2)))
    return centers[order], scores[valid][order]


def test_decode_and_nms_match_jax(flagship):
    out = _port_forward(flagship, **flagship["hints"])
    corners, scores, valid = decode_detections_device(
        out["psm"], out["rm"], t(flagship["anchors"]), torch.eye(4))
    jc, js, jv = flagship["jdet"]
    assert corners.shape == np.asarray(jc).shape
    got_c, got_s = _kept(corners, scores, valid)
    want_c, want_s = _kept(jc, js, jv)
    assert 0 < len(want_c) < valid.shape[0]  # NMS suppressed something
    assert got_c.shape == want_c.shape
    close(got_c, want_c, 1e-3)
    close(got_s, want_s, 1e-4)


def test_bridge_rejects_missing_and_extra_leaves(flagship):
    v = jax.tree_util.tree_map(np.asarray, flagship["variables"])
    params = dict(v["params"])
    params.pop("fusion")
    with pytest.raises(KeyError):
        flax_to_state_dict(HMViT(flagship["cfg"]), dict(v, params=params))
    extra = dict(v["params"], stray={"kernel": np.zeros(3, np.float32)})
    with pytest.raises(KeyError):
        flax_to_state_dict(HMViT(flagship["cfg"]), dict(v, params=extra))


def test_strict_fp32_disables_tf32():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    try:
        with strict_fp32():
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = before


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import hmvit_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(hmvit_tpu_torch.__path__,"
        " 'hmvit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'jaxlib')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_chip_smoke_fails_without_cuda():
    """On a machine without a CUDA device the smoke run must exit
    non-zero and print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    if lines:
        try:
            last = json.loads(lines[-1])
        except ValueError:
            last = None
        assert not (isinstance(last, dict) and last.get("ok"))


# The north star's bf16 bar: the port's bf16 output against the JAX
# package's fp32 output, bounded by the JAX package's own bf16-vs-fp32
# spread on the same model and batch (bench.py's bf16 casts: weights and
# every float array but the geometry in bfloat16, bfloat16 compute in the
# lidar features and the decoder, ``serving_config(..., bf16=True)``)
# times BF16_SPREAD_FACTOR, plus BF16_FLOOR.  The two frameworks round at
# other points, so the port's spread is of the same size as JAX's but not
# equal to it.  The fusion computes in bfloat16 too, as the production
# configuration's does.
BF16_SPREAD_FACTOR = 2.0
BF16_FLOOR = 1e-3


def _bf16_cfg(cfg):
    import copy

    from hmvit_tpu_torch.serving import serving_config

    cfg = copy.deepcopy(cfg)
    cfg["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"] = "bfloat16"
    return serving_config(cfg, bf16=True)


def _read_bf16_runs(flagship, variables, fp32_ref):
    """JAX fp32 (``fp32_ref``, the reference forward of ``variables``),
    JAX bf16 and the port's bf16 forward (plain twins, CPU) on the same
    weights and batch, as float32 numpy: {"psm": (sigmoid scores) ,
    "rm": ...} each."""
    from hmvit_tpu_torch.serving import GEOMETRY_KEYS, batch_to_device

    torch.set_num_threads(1)
    cfg = _bf16_cfg(flagship["cfg"])

    def to_bf16(x):
        return x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x

    jb = {k: (v if k in GEOMETRY_KEYS else to_bf16(v))
          for k, v in ((k, jnp.asarray(v))
                       for k, v in flagship["batch"].items())}
    with widened_bf16_einsum():
        jout = japply(JHMViT(cfg), jax.tree_util.tree_map(
            to_bf16, variables), jb, train=False, **flagship["hints"])
    pm = bridged(HMViT(cfg), variables).to(torch.bfloat16)
    with torch.no_grad():
        pout = pm(batch_to_device(flagship["batch"], "cpu", bf16=True),
                  **flagship["hints"])
    assert pout["psm"].dtype == torch.bfloat16

    def host(x):
        return np.asarray(jnp.asarray(x, jnp.float32)) \
            if not isinstance(x, torch.Tensor) else x.float().numpy()

    runs = {}
    for name, out in (("fp32", fp32_ref), ("jax_bf16", jout),
                      ("port_bf16", pout)):
        runs[name] = {"psm": 1.0 / (1.0 + np.exp(-host(out["psm"]))),
                      "rm": host(out["rm"])}
    return runs


@pytest.fixture(scope="module")
def bf16_runs(flagship):
    """The three forwards (``_read_bf16_runs``) on the flagship's random
    weights, where every score sits near the focal prior 0.01."""
    return _read_bf16_runs(flagship, flagship["variables"], flagship["ref"])


# the span of the fp32 logits of the steep-score case: sigmoid(+-4) covers
# (0.018, 0.982), where the sigmoid's slope reaches 0.25, as on the
# accuracy gate's trained weights (at the prior it is 0.0099)
STEEP_LOGIT = 4.0


@pytest.fixture(scope="module")
def bf16_steep_runs(flagship):
    """The three forwards on weights that put the scores off the prior:
    the flagship's random weights with each detection head's psm conv
    bias set to 0 and its kernel scaled so that the JAX fp32 logits span
    +-STEEP_LOGIT (the head is the model's last, linear layer, so the
    logits without the bias are the reference's minus it).  Both
    frameworks get the identical tree through the bridge."""
    v = jax.tree_util.tree_map(np.array, flagship["variables"])
    dec = v["params"]["HeteroDecoder_0"]
    ego = ("camera_head", "lidar_head")[
        flagship["hints"]["static_ego_modality"]]
    bias = dec[ego]["Conv_0"]["bias"]
    logits = np.asarray(flagship["ref"]["psm"]) - bias[None, :, None, None]
    scale = STEEP_LOGIT / float(np.abs(logits).max())
    for head in ("camera_head", "lidar_head"):
        dec[head]["Conv_0"]["kernel"] = (
            dec[head]["Conv_0"]["kernel"] * scale).astype(np.float32)
        dec[head]["Conv_0"]["bias"] = np.zeros_like(
            dec[head]["Conv_0"]["bias"])
    jb = {k: jnp.asarray(val) for k, val in flagship["batch"].items()}
    ref = japply(JHMViT(flagship["cfg"]), v, jb, train=False,
                 **flagship["hints"])
    return _read_bf16_runs(flagship, v, ref)


def _hold_bf16_spread(runs, key):
    """max |port bf16 - JAX fp32| on sigmoid(psm), and on rm over
    max(1, max |rm|), within BF16_SPREAD_FACTOR x the JAX package's own
    bf16-vs-fp32 spread + BF16_FLOOR; both spreads finite and the bf16
    runs not bit-equal to fp32 (the casts took effect)."""
    ref = runs["fp32"][key]
    scale = max(1.0, float(np.abs(ref).max())) if key == "rm" else 1.0
    spread = {name: float(np.abs(runs[name][key] - ref).max()) / scale
              for name in ("jax_bf16", "port_bf16")}
    assert all(np.isfinite(v) and v > 0 for v in spread.values()), spread
    bar = BF16_SPREAD_FACTOR * spread["jax_bf16"] + BF16_FLOOR
    print(f"{key}: spread against JAX fp32 {spread}, bar {bar}")
    assert spread["port_bf16"] <= bar, (spread, bar)


@pytest.mark.parametrize("key", ["psm", "rm"])
def test_port_bf16_against_jax_fp32(bf16_runs, key):
    """The bar (``_hold_bf16_spread``) at random weights."""
    _hold_bf16_spread(bf16_runs, key)


@pytest.mark.parametrize("key", ["psm", "rm"])
def test_port_bf16_against_jax_fp32_steep_scores(bf16_steep_runs, key):
    """The same bar on weights where the sigmoid is steep (P3): the JAX
    package's own bf16 spread is read at these weights, and the fp32
    scores run from the tail through 0.5, where the slope is 0.25."""
    scores = bf16_steep_runs["fp32"]["psm"]
    assert scores.min() < 0.05 and scores.max() > 0.5, (scores.min(),
                                                        scores.max())
    _hold_bf16_spread(bf16_steep_runs, key)


@pytest.fixture(scope="module")
def bf16_fax_runs(flagship):
    """The three forwards on the flagship's fleet and batch with the
    camera branch of ``hmvit_fax_point_pillar_hetero.yaml`` (FAX) at the
    smoke widths, on random weights."""
    import copy

    from hmvit_tpu_torch.config import load_config

    corpus = load_config(os.path.join(REPO, "hmvit_tpu_torch", "config",
                                      "hypes",
                                      "hmvit_fax_point_pillar_hetero.yaml"))
    cfg = copy.deepcopy(flagship["cfg"])
    cfg["camera"] = dict(corpus["model"]["args"]["camera"], dim=32,
                         bev_size=4, out_dim=64, bev_window=4, heads=2,
                         dim_head=16, encoder_channels=[16, 32, 32, 32])
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in flagship["batch"].items()}
    v = flax_variables(jm, jb, train=False)
    ref = japply(jm, v, jb, train=False, **flagship["hints"])
    return _read_bf16_runs(dict(flagship, cfg=cfg), v, ref)


@pytest.mark.parametrize("key", ["psm", "rm"])
def test_port_bf16_against_jax_fp32_fax_camera(bf16_fax_runs, key):
    """The bar with the FAX camera encoder (its float32 window scores
    over bf16 operands)."""
    _hold_bf16_spread(bf16_fax_runs, key)


def _debug_model(flagship, debug: bool):
    return bridged(HMViT(dict(flagship["cfg"], debug_checks=debug)),
                   flagship["variables"])


@pytest.mark.parametrize("static", [True, False])
def test_serving_bucket_debug_guard(flagship, static):
    """``debug_checks: true`` rejects a camera_bucket larger than the
    batch's true camera count (lidar agents inside the bucket would
    receive camera-encoded features), as the JAX model does
    (tests/test_hetero_fusion.py::test_serving_bucket_debug_guard): the
    exact bucket passes and gives the unguarded model's output, the
    bucket + 1 raises, with the fleet's layout given on the host
    (``static_modes``) or read from the batch."""
    hints = dict(flagship["hints"])
    if not static:
        hints.pop("static_modes")
    exact = hints["camera_bucket"]
    tb = {k: t(v) for k, v in flagship["batch"].items()}
    model = _debug_model(flagship, True)
    with torch.no_grad():
        out = model(tb, **hints)
        want = _port_forward(flagship, **hints)
        for key in ("psm", "rm"):
            assert torch.equal(out[key], want[key])
        with pytest.raises(ValueError, match="camera count"):
            model(tb, **dict(hints, camera_bucket=exact + 1))


def test_debug_guard_checks_static_modes(flagship):
    """Under ``debug_checks`` a ``static_modes`` that differs from the
    batch's ``mode`` raises, even where the exact bucket would pass and
    where a wrong bucket agrees with the wrong layout: the guard reads the
    batch, not the hint."""
    hints = dict(flagship["hints"])
    modes = tuple(hints["static_modes"])
    wrong = tuple(1 - m for m in modes)
    tb = {k: t(v) for k, v in flagship["batch"].items()}
    model = _debug_model(flagship, True)
    with torch.no_grad():
        for bucket in (hints["camera_bucket"], wrong.count(0)):
            with pytest.raises(ValueError, match="static_modes"):
                model(tb, **dict(hints, static_modes=wrong,
                                 camera_bucket=bucket))


def _no_host_reads(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("host read of a tensor")

    for name in ("item", "cpu", "tolist", "numpy", "__int__", "__bool__",
                 "__float__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


@pytest.mark.parametrize("debug,static,reads", [
    (False, False, False), (False, True, False), (True, False, True),
    (True, True, True)])
def test_bucket_branch_host_reads(flagship, monkeypatch, debug, static,
                                  reads):
    """The bucket branch reads nothing back to the host unless
    ``debug_checks`` is set: then it takes one read of ``mode``, with or
    without the fleet's layout (shown here by a forward under a mock that
    refuses every host read)."""
    hints = dict(flagship["hints"])
    if not static:
        hints.pop("static_modes")
    model = _debug_model(flagship, debug)
    tb = {k: t(v) for k, v in flagship["batch"].items()}
    _no_host_reads(monkeypatch)
    with torch.no_grad():
        if reads:
            with pytest.raises(AssertionError, match="host read"):
                model(tb, **hints)
        else:
            out = model(tb, **hints)
            assert tuple(out["psm"].shape) == (1, 2, 16, 16)


def test_train_mode_is_refused(flagship):
    """Named for what it held while the port was eval only; train mode is
    ported now and no longer refused.  A new model is in eval mode;
    ``train()`` / ``train(True)`` put every module in train mode (batch
    statistics, dropout, remat) and ``eval()`` / ``train(False)`` put
    every module back."""
    from hmvit_tpu_torch.nn import init_parameters

    model = HMViT(flagship["cfg"])
    assert not any(m.training for m in model.modules())
    for call in (model.train, lambda: model.train(True)):
        assert call() is model
        assert all(m.training for m in model.modules())
        assert model.eval() is model
        assert not any(m.training for m in model.modules())
    assert model.train(True).train(False) is model
    assert not any(m.training for m in model.modules())
    assert init_parameters(model, seed=0) is model
    assert not any(m.training for m in model.modules())


@pytest.fixture(scope="module")
def batch2():
    """A batch of two tiny fleets (seed 0), and the port's tiny model with
    the JAX package's weights."""
    torch.set_num_threads(1)
    cfg = tiny_flagship_cfg()
    batch = request_batch(0, max_points=512, image_size=64, num_cams=2,
                          lidar_range=RANGE, batch_size=2)
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = flax_variables(jm, jb, train=False)
    return dict(cfg=cfg, batch=batch, jm=jm, jb=jb, v=v,
                model=bridged(HMViT(cfg), v).requires_grad_(False))


def test_batch2_equals_two_batch1_forwards_and_jax(batch2):
    """The serving hints of a batch of 2 (``serving_hints(...,
    batch_size=2)``) count the cameras of the whole batch (4); the port's
    forward then equals its batch-1 forward of each fleet (1e-5,
    convolutions over another batch size) and the JAX package's batch-2
    forward with the same hints but the camera bucket (1e-4, as above).
    JAX's bucketed branch takes a bucket of 4 >= the 4 agents of ONE row
    for an all-camera batch, so it is held with the run-both encoders it
    is documented to equal."""
    batch, model = batch2["batch"], batch2["model"]
    hints = serving_hints(batch["mode"][0], 4, batch_size=2)
    assert hints["camera_bucket"] == 4
    with torch.no_grad():
        out = model({k: t(x) for k, x in batch.items()}, **hints)
        for i in range(2):
            one = model({k: t(x[i:i + 1]) for k, x in batch.items()},
                        **serving_hints(batch["mode"][i], 4))
            for key in ("psm", "rm"):
                close(out[key][i:i + 1], one[key].numpy(), 1e-5)
    ref = japply(batch2["jm"], batch2["v"], batch2["jb"], train=False,
                 **dict(hints, camera_bucket=None))
    for key in ("psm", "rm"):
        assert tuple(out[key].shape)[0] == 2
        close(out[key], ref[key], 1e-4)
