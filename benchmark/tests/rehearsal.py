"""A cell at CPU widths for the benchmark's own tests: the production
model's structure at widths a CPU runs in seconds (64^2 pillars, 16^2 x
64 BEV, window 4, 4 heads of 16, 2 cameras of 64^2), a traffic of the
same kind with its agents inside that map, and the graph server replaced
by the same model run eagerly (CUDA graphs need the card).  ``cpu_spec``
and ``on_cpu`` let a test drive the rest of a run without a card."""
from __future__ import annotations

import contextlib
import copy

import torch

from benchmark import manifest

RANGE = [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0]


def tiny_model(model: dict) -> dict:
    """``model`` (a cell's configuration) at CPU widths, as
    ``hmvit_tpu_torch.perf_lab.rehearsal_cfg`` shrinks it."""
    cfg = copy.deepcopy(model)
    lidar = cfg["lidar"]
    lidar.update(voxel_size=[0.64, 0.64, 4.0], lidar_range=RANGE)
    lidar["pillar_vfe"]["num_filters"] = [32]
    lidar["point_pillar_scatter"].update(num_features=32,
                                         grid_size=[64, 64, 1])
    lidar["base_bev_backbone"].update(
        layer_nums=[1, 1, 1], num_filters=[32, 32, 32],
        num_upsample_filter=[32, 32, 32])
    lidar["shrink_header"].update(dim=[64], input_dim=96)
    cfg["camera"].update(fpn_channels=16, dim=32, bev_size=16, out_dim=64,
                         num_layers=1, heads=2, window=4,
                         num_points_in_pillar=2, bev_range=20.48, num_cams=2)
    if cfg["camera"]["encoder"] == "bevformer_ref":
        cfg["camera"].update(bev_h=16, ffn_dim=64, fpn_channels=64, dim=64,
                             pc_range=[-20.48, -20.48, -3.0, 20.48, 20.48,
                                       1.0])
    blk = cfg["hetero_fusion"]["hetero_fusion_block"]
    blk.update(input_dim=64, mlp_dim=64, window_size=4, dim_head=16)
    blk["spatial_transform"]["voxel_size"] = [0.64, 0.64, 4.0]
    cfg["hetero_decoder"].update(input_dim=64, num_layer=1, num_ch_dec=[64])
    return cfg


def cpu_spec(cell: str) -> dict:
    """The cell's run spec with its model, anchors and traffic at CPU
    widths (its limits and metrics as they are)."""
    spec = manifest.cell(cell)
    config = spec["config"]
    config["model"] = tiny_model(config["model"])
    config["anchor_args"].update(W=64, H=64, vw=0.64, vh=0.64,
                                 cav_lidar_range=RANGE)
    config["fusion_geometry"] = {"discrete_ratio": 0.64,
                                 "downsample_rate": 4}
    spec["traffic"].update(comm_range_m=12.0, vehicle_area_m=18.0,
                           max_points=512, image_size=64, num_cams=2,
                           pool=3, vehicles=6, points_per_vehicle=32,
                           compare_cycles=2)
    return spec


class EagerServer:
    """``CompiledServer``'s interface over the eager model (no graphs)."""

    def __init__(self, model, hints, example, anchors, transform):
        from hmvit_tpu_torch.postprocess import decode_detections_device

        self.model, self.anchors, self.transform = model, anchors, transform
        self.decode = decode_detections_device

    def __call__(self, request, hints):
        with torch.no_grad():
            out = self.model(request, **hints)
            return out, [self.decode(out["psm"], out["rm"], self.anchors,
                                     self.transform)]


@contextlib.contextmanager
def on_cpu(monkeypatch):
    """Inside: the runners run on the CPU (the graph server eager, the
    CUDA calls they make to synchronise and read memory no-ops)."""
    import hmvit_tpu_torch.graph_server as gs

    monkeypatch.setattr(gs, "CompiledServer", EagerServer)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    yield torch.device("cpu")
