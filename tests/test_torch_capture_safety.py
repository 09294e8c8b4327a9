"""The serving path is capture-safe: a CUDA graph can record it only if
it reads nothing back to the host and copies nothing from pageable host
memory.  Here, on the CPU, a guard refuses every host read of a tensor,
every index made of host data (a list, a numpy array) and every
``torch.tensor`` / ``torch.as_tensor`` with a device, around the
tiny-width serving forward and ``decode_detections_device`` of the
split, ``use_fused_wa`` and expansion (v1, v2) configurations (after one
unguarded warm-up forward, as the graph server warms up before its
capture: the port's device constants are made there).  The guarded
forward equals the JAX package's at 1e-4, as ``test_torch_hmvit.py``
holds it.  The graph server refuses CPU tensors and a model with
``debug_checks``, and ``debug_checks`` raises under a capture."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.data.anchors import generate_anchor_grid
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu_torch.graph_server import CompiledServer
from hmvit_tpu_torch.models import hmvit as phmvit
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import decode_detections_device
from tiny_cfg import ANCHOR_ARGS
from torch_parity import NoHostReads, bridged, close, flax_variables, \
    japply, no_host_copies, t, tiny_batch, tiny_flagship_cfg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def config(name: str) -> dict:
    cfg = tiny_flagship_cfg()
    if name == "fused_wa":
        # the smallest map the fused route's shape rule admits (64^2),
        # as tests/test_torch_hmvit.py::test_hmvit_use_fused_wa_matches_jax
        cfg["lidar"]["voxel_size"] = [0.16, 0.16, 4.0]
        cfg["lidar"]["point_pillar_scatter"]["grid_size"] = [256, 256, 1]
        cfg["camera"]["bev_size"] = 64
        blk = cfg["hetero_fusion"]["hetero_fusion_block"]
        blk["spatial_transform"]["voxel_size"] = [0.16, 0.16, 4]
        blk["use_fused_wa"] = True
    elif name.startswith("expand"):
        cfg["lidar"]["scatter_variant"] = name[-2:]
    return cfg


def hints_of(batch) -> dict:
    modes = tuple(int(m) for m in batch["mode"][0, :4])
    return dict(camera_bucket=int(sum(m == 0 for m in modes)),
                active_agents=4, static_ego_modality=modes[0],
                static_modes=modes)


@pytest.mark.parametrize("name", ["split", "fused_wa", "expand_v1",
                                  "expand_v2"])
def test_serving_path_is_capture_safe(name, monkeypatch):
    cfg = config(name)
    batch, _ = tiny_batch(1)
    hints = hints_of(batch)
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = flax_variables(jm, jb, train=False)
    ref = japply(jm, v, jb, train=False, **hints)
    model = bridged(HMViT(cfg), v)
    tb = {k: t(x) for k, x in batch.items()}
    grid = cfg["lidar"]["point_pillar_scatter"]["grid_size"][0]
    anchors = torch.as_tensor(generate_anchor_grid(
        dict(ANCHOR_ARGS, W=grid, H=grid,
             vw=cfg["lidar"]["voxel_size"][0],
             vh=cfg["lidar"]["voxel_size"][1]), "hwl"), dtype=torch.float32)
    eye = torch.eye(4)
    with torch.no_grad():
        warm = model(tb, **hints)  # the warm-up: device constants made
        want = decode_detections_device(warm["psm"], warm["rm"], anchors,
                                        eye)
        with NoHostReads(), no_host_copies(monkeypatch):
            out = model(tb, **hints)
            det = decode_detections_device(out["psm"], out["rm"], anchors,
                                           eye)
    for key in ("psm", "rm"):
        assert torch.equal(out[key], warm[key])
        close(out[key], ref[key], 1e-4)
    for got, exp in zip(det, want):
        assert torch.equal(got, exp)


def test_guards_catch_what_a_capture_refuses(monkeypatch):
    """The guards do fire: on a host read, on a list index and on a
    host-to-device copy."""
    x = torch.arange(4.0)
    with pytest.raises(AssertionError, match="host read"), NoHostReads():
        int(x.sum())
    with pytest.raises(AssertionError, match="host data"), NoHostReads():
        x[[0, 2]]
    with pytest.raises(AssertionError, match="host-to-device"), \
            no_host_copies(monkeypatch):
        torch.tensor([1.0], device="cpu")


@pytest.fixture(scope="module")
def small_server_parts():
    cfg = tiny_flagship_cfg()
    batch, _ = tiny_batch(0)
    return cfg, {k: t(v) for k, v in batch.items()}, hints_of(batch)


def test_graph_server_refuses_cpu_tensors(small_server_parts):
    cfg, tb, hints = small_server_parts
    with pytest.raises(ValueError, match="CUDA"):
        CompiledServer(HMViT(cfg), hints, tb, torch.zeros(16, 16, 2, 7),
                       torch.eye(4))


def test_graph_server_refuses_debug_checks(small_server_parts):
    cfg, tb, hints = small_server_parts
    with pytest.raises(ValueError, match="debug_checks"):
        CompiledServer(HMViT(dict(cfg, debug_checks=True)), hints, tb,
                       torch.zeros(16, 16, 2, 7), torch.eye(4))


def test_debug_checks_raise_under_capture(small_server_parts, monkeypatch):
    """The one host read of the bucket branch names its check when a
    capture is running, instead of failing inside CUDA."""
    cfg, tb, hints = small_server_parts
    model = init_parameters(HMViT(dict(cfg, debug_checks=True)), seed=0)
    monkeypatch.setattr(phmvit, "_capturing", lambda x: True)
    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="debug_checks.*capture"):
        model(tb, **hints)
    monkeypatch.setattr(phmvit, "_capturing", lambda x: False)
    with torch.no_grad():
        out = model(tb, **hints)
    assert np.isfinite(out["psm"].numpy()).all()
