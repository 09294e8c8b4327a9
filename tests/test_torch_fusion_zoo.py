"""Port parity of the fusion zoo and the cooperative detection
assemblies: F-Cooper, agent attention, DiscoNet, V2VNet, SwapFusion and
V2X-ViT (with and without the agents' prior encoding), the per-stage
agent fusion of the lidar BEV backbone, HMViT with each
``fusion_override``, ``CooperativeDetector`` (lidar, per-stage lidar and
camera) and ``CameraDetector``.  The same weights through the bridge and
the same inputs (numpy, seeded) against the JAX package on the CPU.

* Each fusion at the JAX test's shapes (``tests/test_fusion_zoo.py``:
  B, L, H, W, C = 1, 3, 16, 16, 32) with rigid agent poses and a padded
  slot, within 1e-5 over max(1, max |ref|); the JAX test's masking
  invariants held by the port.
* ``AttBEVBackbone`` at ``tests/test_att_bev_backbone.py``'s shapes,
  within 1e-5 over max(1, max |ref|).
* The assemblies on the corpus configs shrunk to the smoke widths
  (``smoke_hetero_tiny.yaml``), psm and rm within 1e-4, the parameter
  count the flax tree's.
* One train step through ``fusion_override: disconet``: the port in
  float32 against the JAX step in float64, each gradient within 1e-4 of
  its scale or twice JAX's own float32 distance (the rule of
  ``tests/test_torch_train_step.py``); DiscoNet's BatchNorm statistics
  do not move in either.
* The JAX package's quirks, reproduced: DiscoNet's BatchNorm on its
  running statistics in train mode, V2X-ViT deterministic in train
  mode, ``fusion_override`` without the config's fusion arguments, and
  the dtypes of flax's promotion (a bf16 map under float32 parameters
  fuses in float32).
* Each fusion's eval forward reads nothing back to the host (a CUDA
  graph can capture it).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import pillar_encoder as jpillar
from hmvit_tpu.models import zoo as jzoo
from hmvit_tpu.models.fusion import (
    AttFusion as JAtt,
    DiscoNetFusion as JDisco,
    SpatialFusion as JSpatial,
    SwapFusionEncoder as JSwap,
    V2VNetFusion as JV2V,
    V2XTransformer as JV2X,
)
from hmvit_tpu.models.fusion import make_fusion as jmake_fusion
from hmvit_tpu_torch.config import load_config
from hmvit_tpu_torch.models import pillar_encoder, zoo
from hmvit_tpu_torch.models.fusion import (
    AttFusion,
    DiscoNetFusion,
    SpatialFusion,
    SwapFusionEncoder,
    V2VNetFusion,
    V2XTransformer,
    make_fusion,
)
from hmvit_tpu_torch.models.fusion import v2xvit
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from torch_parity import NoHostReads, bridged, close, flax_variables, \
    japply, no_host_copies, rigid_pairwise, t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_HYPES = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes")
B, L, H, W, C = 1, 3, 16, 16, 32
GEO = dict(discrete_ratio=1.0, downsample_rate=1)

# the JAX test's module configurations, each with its port counterpart
MODULES = {
    "fcooper": (lambda: JSpatial(**GEO), lambda: SpatialFusion(**GEO)),
    "att": (lambda: JAtt(C, **GEO), lambda: AttFusion(C, **GEO)),
    "disconet": (lambda: JDisco(C, **GEO), lambda: DiscoNetFusion(C, **GEO)),
    "v2vnet": (lambda: JV2V(C, num_rounds=1, **GEO),
               lambda: V2VNetFusion(C, num_rounds=1, **GEO)),
    "swap": (lambda: JSwap(C, depth=1, window=4, dim_head=8, **GEO),
             lambda: SwapFusionEncoder(C, depth=1, window=4, dim_head=8,
                                       **GEO)),
    "v2xvit": (lambda: JV2X(C, depth=1, heads=4, windows=(4,), **GEO),
               lambda: V2XTransformer(C, depth=1, heads=4, windows=(4,),
                                      **GEO)),
}
# make_fusion at its defaults (V2X-ViT: windows 4, 8, 16; V2VNet: two
# rounds; SwapFusion: window 8), DiscoNet with the config's arguments
SPATIAL = {"voxel_size": [1.0, 1.0, 4.0], "downsample_rate": 1}
REGISTRY = [("fcooper", None), ("att", None), ("disconet", None),
            ("disconet", {"num_iteration": 2, "use_mask": False}),
            ("v2vnet", None), ("swap", None), ("v2xvit", None)]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def scaled_close(got, want, atol):
    scale = max(1.0, float(np.abs(np.asarray(want)).max()))
    close(got / scale, np.asarray(want) / scale, atol)


def fusion_inputs(seed=0, padded=True):
    """(x, mode, pairwise, agent_mask): rigid poses within 4 pixels,
    the last slot padding when ``padded``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, W, C)).astype(np.float32)
    mode = np.array([[0, 1, 1]], np.int32)
    pairwise = rigid_pairwise(rng, B, L, max_t=4.0)
    agent_mask = np.array([[1, 1, 0 if padded else 1]], np.float32)
    return x, mode, pairwise, agent_mask


def parity(jm, pm, inputs, seed=0, **kwargs):
    """(port output, JAX output) on the same random weights."""
    v = flax_variables(jm, *inputs, seed=seed, **kwargs)
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, **kwargs))(v, *inputs)
    with torch.no_grad():
        out = bridged(pm, v)(*(t(a) for a in inputs),
                             **{k: t(a) for k, a in kwargs.items()})
    return out, ref, v


@pytest.mark.parametrize("name", sorted(MODULES))
@pytest.mark.parametrize("padded", [True, False], ids=["padded", "full"])
def test_fusion_matches_jax(name, padded):
    jm, pm = MODULES[name]
    out, ref, _ = parity(jm(), pm(), fusion_inputs(0, padded))
    assert tuple(out.shape) == ref.shape == (B, H, W, C)
    scaled_close(out, ref, 1e-5)


@pytest.mark.parametrize("name,args", REGISTRY,
                         ids=[n + ("_args" if a else "") for n, a in REGISTRY])
def test_make_fusion_matches_jax(name, args):
    """The registry's modules at their defaults, the same classes."""
    jm = jmake_fusion(name, C, SPATIAL, args)
    pm = make_fusion(name, C, SPATIAL, args)
    assert type(pm).__name__ == type(jm).__name__
    out, ref, _ = parity(jm, pm, fusion_inputs(1))
    scaled_close(out, ref, 1e-5)


@pytest.mark.parametrize("correction", [False, True],
                         ids=["prior", "prior_spatial_correction"])
def test_v2xvit_prior_encoding_matches_jax(correction):
    """An infra agent (the third node type) and a delay above max_delay
    (clipped in the RTE table), the delayed-ego correction composed."""
    inputs = fusion_inputs(2, padded=False)
    prior = np.array([[[0.4, 0.0, 0.0], [0.6, 13.0, 0.0],
                       [0.2, 2.0, 1.0]]], np.float32)
    kwargs = {"prior_encoding": prior}
    if correction:
        kwargs["spatial_correction"] = rigid_pairwise(
            np.random.default_rng(3), B, L, max_t=2.0)[:, :, 0]
    jm = JV2X(C, depth=1, heads=4, windows=(4, 8), **GEO)
    pm = V2XTransformer(C, depth=1, heads=4, windows=(4, 8),
                        prior_encoding=True, **GEO)
    out, ref, v = parity(jm, pm, inputs, **kwargs)
    assert v["params"]["HGTCavAttention_0"]["relation_att"].shape[0] == 9
    scaled_close(out, ref, 1e-5)
    with pytest.raises(ValueError, match="prior_encoding"):
        pm(*(t(a) for a in inputs))


# -- the JAX test's masking invariants, on the port ---------------------

@pytest.mark.parametrize("name", sorted(MODULES))
def test_fusion_interface_and_masking(name):
    x, mode, pairwise, agent_mask = (t(a) for a in fusion_inputs(
        0, padded=False))
    pairwise = torch.eye(4).expand(B, L, L, 4, 4)
    pm = init_parameters(MODULES[name][1](), seed=0)
    with torch.no_grad():
        out = pm(x, mode, pairwise, agent_mask)
        assert tuple(out.shape) == (B, H, W, C)
        assert torch.isfinite(out).all()
        # a masked-out agent's features do not reach the ego output
        mask2 = torch.tensor([[1.0, 1.0, 0.0]])
        base = pm(x, mode, pairwise, mask2)
        poisoned = x.clone()
        poisoned[:, 2] = 777.0
        close(pm(poisoned, mode, pairwise, mask2), base.numpy(), 2e-4)
        # a live agent's features do
        moved = x.clone()
        moved[:, 1, :, :, 0] += 3.0
        assert float((pm(moved, mode, pairwise, agent_mask)
                      - out).abs().max()) > 1e-4


def test_fcooper_is_masked_max():
    x, mode, _, agent_mask = (t(a) for a in fusion_inputs(0, False))
    out = SpatialFusion(**GEO)(x, mode, torch.eye(4).expand(B, L, L, 4, 4),
                               agent_mask)
    close(out, x.amax(dim=1).numpy(), 1e-5)


# -- the per-stage agent fusion of the lidar backbone -------------------

ATT_BEV = {"layer_nums": [1, 1], "layer_strides": [2, 2],
           "num_filters": [32, 32], "upsample_strides": [1, 2],
           "num_upsample_filter": [32, 32]}


def test_att_bev_backbone_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 3, 64, 64, 32)).astype(np.float32)
    agent_mask = np.array([[1.0, 1.0, 0.0]], np.float32)
    jm = jpillar.AttBEVBackbone(
        ATT_BEV["layer_nums"], ATT_BEV["layer_strides"],
        ATT_BEV["num_filters"], ATT_BEV["upsample_strides"],
        ATT_BEV["num_upsample_filter"])
    pm = pillar_encoder.AttBEVBackbone(
        32, ATT_BEV["layer_nums"], ATT_BEV["layer_strides"],
        ATT_BEV["num_filters"], ATT_BEV["upsample_strides"],
        ATT_BEV["num_upsample_filter"])
    out, ref, _ = parity(jm, pm, (x, agent_mask))
    assert tuple(out.shape) == ref.shape == (1, 32, 32, 64)
    scaled_close(out, ref, 1e-5)
    close(pillar_encoder.pixel_agent_attention(t(x), t(agent_mask)),
          jpillar.pixel_agent_attention(jnp.asarray(x),
                                        jnp.asarray(agent_mask)), 1e-5)


# -- the assemblies on shrunk corpus configs ----------------------------

SMOKE = load_config(os.path.join(PORT_HYPES, "smoke_hetero_tiny.yaml"))
SMOKE_ARGS = SMOKE["model"]["args"]
# the corpus's FAX camera block at the smoke camera widths
FAX_CAMERA = {"encoder": "fax", "dim": 32, "bev_size": 4, "out_dim": 64,
              "num_blocks": 1, "decoder_layers": 2, "bev_window": 4,
              "heads": 2, "dim_head": 16,
              "encoder_channels": [16, 32, 32, 32]}
BEVFORMER_CAMERA = dict(FAX_CAMERA, encoder="bevformer", heads=2, window=4,
                        num_layers=2, num_cams=4)
# each fusion_override under the corpus name of a mixed configuration
MIXED = {"fcooper": "fax_point_pillar_fcooper",
         "att": "fax_point_pillar_att_fuse",
         "disconet": "bevformer_point_pillar_disconet",
         "v2vnet": "fax_point_pillar_v2vnet",
         "swap": "fax_point_pillar_fax",
         "v2xvit": "fax_point_pillar_v2xt"}


def mixed_model_cfg(fusion: str, **extra) -> dict:
    name = MIXED[fusion]
    args = copy.deepcopy(SMOKE_ARGS)
    args["camera"] = dict(BEVFORMER_CAMERA if name.startswith("bevformer")
                          else FAX_CAMERA)
    args.update(extra)
    return {"core_method": name, "args": args}


@pytest.fixture(scope="module")
def smoke_batch():
    """A lidar ego, a camera agent and a padded slot, 4 cameras of 64^2,
    the agents' prior encoding (an infra flag on the camera agent)."""
    from hmvit_tpu.data.synthetic import make_hetero_batch

    batch, _ = make_hetero_batch(
        seed=3, max_cav=3, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=SMOKE["preprocess"]["cav_lidar_range"])
    batch["mode"][:, :2] = (1, 0)
    batch["prior_encoding"][0, :2] = ((0.3, 0.0, 0.0), (0.1, 12.0, 1.0))
    return batch


def assembly_parity(model_cfg, batch, hints=({},)):
    """Port and JAX models of ``model_cfg`` on the same random weights:
    the parameter counts equal, psm and rm within 1e-4 (each hint set)."""
    jm = jzoo.build_model(model_cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = flax_variables(jm, jb, train=False)
    pm = bridged(zoo.build_model(model_cfg), v)
    assert type(pm).__name__ == type(jm).__name__
    n_flax = sum(int(np.prod(x.shape))
                 for x in jax.tree_util.tree_leaves(v["params"]))
    assert sum(p.numel() for p in pm.parameters()) == n_flax
    tb = {k: t(x) for k, x in batch.items()}
    for kw in hints:
        ref = japply(jm, v, jb, train=False, **kw)
        with torch.no_grad():
            out = pm(tb, **kw)
        for key in ("psm", "rm"):
            assert tuple(out[key].shape) == ref[key].shape
            close(out[key], ref[key], 1e-4)
    return pm, v


@pytest.mark.parametrize("fusion", sorted(MIXED))
def test_hmvit_fusion_override_matches_jax(smoke_batch, fusion):
    from hmvit_tpu_torch.serving import serving_hints

    hints = ({}, serving_hints(smoke_batch["mode"][0], 2))
    pm, v = assembly_parity(mixed_model_cfg(fusion), smoke_batch, hints)
    assert isinstance(pm, HMViT) and pm.fusion_override == fusion
    assert not hasattr(pm, "fusion")


def lidar_cfg(core_method: str, **extra) -> dict:
    args = {k: copy.deepcopy(SMOKE_ARGS[k])
            for k in ("anchor_number", "lidar", "spatial_transform")}
    args.update(extra)
    return {"core_method": core_method, "args": args}


@pytest.mark.parametrize("core_method", ["point_pillar_v2xt",
                                         "point_pillar_intermediate",
                                         "point_pillar_disconet"])
def test_cooperative_detector_lidar_matches_jax(smoke_batch, core_method):
    """V2X-ViT without the prior (the JAX assembly passes none), the
    per-stage fusion on the points projected into the ego frame, and
    DiscoNet with the config's own arguments (which this assembly
    passes) under a decoder."""
    extra = {}
    if core_method == "point_pillar_disconet":
        extra = {"disconet_fusion": {"num_iteration": 2, "use_mask": False},
                 "decoder": {"num_layer": 1, "num_ch_dec": [32]}}
    pm, v = assembly_parity(lidar_cfg(core_method, **extra), smoke_batch)
    if core_method == "point_pillar_disconet":
        assert pm.DiscoNetFusion_0.num_iteration == 2
        assert not pm.DiscoNetFusion_0.use_mask


def camera_cfg(core_method: str) -> dict:
    args = {"anchor_number": 2, "camera": dict(FAX_CAMERA),
            "spatial_transform": copy.deepcopy(SMOKE_ARGS[
                "spatial_transform"]),
            "decoder": {"num_layer": 1, "num_ch_dec": [32]}}
    return {"core_method": core_method, "args": args}


@pytest.mark.parametrize("core_method", ["corpbevt", "cvt_nofusion"])
def test_camera_assemblies_match_jax(smoke_batch, core_method):
    """The camera-only CooperativeDetector (SwapFusion) and the
    single-agent CameraDetector."""
    cam_batch = dict(smoke_batch, mode=np.zeros_like(smoke_batch["mode"]))
    assembly_parity(camera_cfg(core_method), cam_batch)


def test_point_pillar_detector_takes_a_tools_batch(smoke_batch):
    """The single-agent PointPillars through the batch of the tools: the
    ego slot's cloud, equal to the JAX module on it."""
    cfg = lidar_cfg("point_pillar")
    jm = jzoo.build_model(cfg)
    pts = smoke_batch["points"][:, 0]
    pmask = smoke_batch["points_mask"][:, 0]
    v = flax_variables(jm, pts, pmask)
    ref = japply(jm, v, pts, pmask)
    pm = bridged(zoo.build_model(cfg), v)
    with torch.no_grad():
        out = pm({k: t(x) for k, x in smoke_batch.items()})
    for key in ("psm", "rm"):
        close(out[key], ref[key], 1e-4)


# -- the JAX package's quirks --------------------------------------------

def test_disconet_batchnorm_keeps_running_statistics_in_train_mode():
    inputs = [t(a) for a in fusion_inputs(5)]
    pm = init_parameters(DiscoNetFusion(C, **GEO), seed=0)
    scorer = pm.pixel_weighted_fusion
    scorer.BatchNorm_0.running_mean.normal_(generator=torch.Generator()
                                            .manual_seed(0))
    before = {k: v.clone() for k, v in pm.state_dict().items()}
    with torch.no_grad():
        want = pm.eval()(*inputs)
        got = pm.train()(*inputs)
    assert pm.training and not any(m.training for m in scorer.modules())
    assert torch.equal(got, want)
    assert all(torch.equal(before[k], v) for k, v in pm.state_dict().items())


def test_v2xvit_deterministic_in_train_mode():
    inputs = [t(a) for a in fusion_inputs(6)]
    pm = init_parameters(make_fusion("v2xvit", C, SPATIAL), seed=0)
    with torch.no_grad():
        want = pm.eval()(*inputs)
        got = pm.train()(*inputs)
    assert torch.equal(got, want)


def test_fusion_override_passes_no_fusion_arguments(smoke_batch):
    """HMViT builds DiscoNet at its defaults whatever the config's
    ``disconet_fusion`` block says, as the JAX model does."""
    cfg = mixed_model_cfg(
        "disconet", disconet_fusion={"num_iteration": 2, "use_mask": False})
    pm, v = assembly_parity(cfg, smoke_batch)
    assert pm.DiscoNetFusion_0.num_iteration == 1
    assert pm.DiscoNetFusion_0.use_mask


@pytest.mark.parametrize("params", ["float32", "bfloat16"])
def test_v2xvit_dtypes_follow_flax_promotion(params):
    """A bf16 map fuses in the types of flax's promotion: the window
    attentions take the type JAX's pyramid input (``LayerNorm_0``'s
    output) has, float32 under float32 parameters and, under bf16
    parameters too, since the HGT messages leave float32 einsums; the
    output type is JAX's."""
    x, mode, pairwise, agent_mask = fusion_inputs(7)
    jm = jmake_fusion("v2xvit", C, SPATIAL)
    v = flax_variables(jm, x, mode, pairwise, agent_mask)
    pm = bridged(make_fusion("v2xvit", C, SPATIAL), v)
    if params == "bfloat16":
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), v)
        pm = pm.to(torch.bfloat16)
    xb = jnp.asarray(x, jnp.bfloat16)
    from torch_parity import widened_bf16_einsum

    with widened_bf16_einsum():
        ref, state = jax.jit(lambda v, *a: jm.apply(
            v, *a, capture_intermediates=True, mutable=["intermediates"]))(
                v, xb, mode, pairwise, agent_mask)
    jax_in = state["intermediates"]["LayerNorm_0"]["__call__"][0].dtype
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda m, a: seen.append(a[0].dtype)) for m in pm.modules()
        if isinstance(m, v2xvit.WindowSelfAttention)]
    with torch.no_grad():
        out = pm(t(x).to(torch.bfloat16), t(mode), t(pairwise),
                 t(agent_mask))
    for h in hooks:
        h.remove()
    assert [str(d).split(".")[-1] for d in seen] == [str(jax_in)] * 3
    assert seen[0] == torch.float32
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)


# -- one train step through fusion_override: disconet -----------------------

def test_disconet_train_step_matches_jax_and_keeps_statistics(smoke_batch):
    from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
    from hmvit_tpu.train.trainer import labels_for_batch as jlabels
    from hmvit_tpu_torch.bridge import flax_to_state_dict
    from hmvit_tpu_torch.postprocess import AnchorPostprocessor
    from hmvit_tpu_torch.train.trainer import create_train_state, \
        labels_for_batch, make_train_step
    from torch_parity import held_to_yardstick, jax_adamw_steps

    cfg = mixed_model_cfg("disconet")
    jm = jzoo.build_model(cfg)
    jb = {k: jnp.asarray(v) for k, v in smoke_batch.items()}
    variables = flax_variables(jm, jb, train=False)
    post = SMOKE["postprocess"]
    jpp = JPostprocessor(post)
    jlab = {k: np.asarray(v) for k, v in jlabels(
        jpp, jpp.generate_anchor_box(), smoke_batch).items()}
    ref = {x64: jax_adamw_steps(jm, variables, smoke_batch, jlab, x64,
                                1e-3, 1e-2, steps=1)[0][0]
           for x64 in (True, False)}
    model = bridged(zoo.build_model(cfg), variables)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
    pp = AnchorPostprocessor(post)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), smoke_batch)
    state = create_train_state(model, opt)
    scorer = "DiscoNetFusion_0.pixel_weighted_fusion."
    stats0 = {k: v.clone() for k, v in model.state_dict().items()
              if k.startswith(scorer) and "running" in k}
    state, parts = make_train_step(model, opt)(
        state, {k: t(v) for k, v in smoke_batch.items()}, labels)
    grads = {n: p.grad for n, p in model.named_parameters()}

    def layout(tree):
        return flax_to_state_dict(zoo.build_model(cfg), {
            "params": tree[1], "batch_stats": tree[2]})

    (loss64, g64), (_, g32) = ((r[0], layout(r)) for r in (ref[True],
                                                           ref[False]))
    assert abs(float(parts["total_loss"]) - loss64) <= 1e-5 * abs(loss64)
    worst = held_to_yardstick(grads, g64, g32, 1e-4)
    assert worst[0] <= 1.0, worst
    # the scorer's statistics: unmoved in the port and in JAX
    for k, v in stats0.items():
        assert torch.equal(model.state_dict()[k], v)
        assert torch.equal(g64[k], v.double())


# -- capture safety -----------------------------------------------------------

@pytest.mark.parametrize("name", ["fcooper", "att", "disconet", "v2vnet",
                                  "swap", "v2xvit"])
def test_fusions_read_nothing_back(name, monkeypatch):
    """After one warm-up forward (the device constants made), the eval
    forward makes no host read and no host-to-device copy."""
    inputs = [t(a) for a in fusion_inputs(8)]
    kwargs = {}
    prior = name == "v2xvit"
    if prior:
        kwargs["prior_encoding"] = torch.tensor(
            [[[0.4, 0.0, 0.0], [0.6, 13.0, 0.0], [0.2, 2.0, 1.0]]])
    pm = init_parameters(make_fusion(name, C, SPATIAL,
                                     prior_encoding=prior), seed=0).eval()
    with torch.no_grad():
        warm = pm(*inputs, **kwargs)
        with NoHostReads(), no_host_copies(monkeypatch):
            out = pm(*inputs, **kwargs)
    assert torch.equal(out, warm)
