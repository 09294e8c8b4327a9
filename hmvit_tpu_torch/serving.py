"""Serving helpers for :class:`HMViT`: the production configuration, its
bfloat16 or float32 serving variants, the static hints a server passes
to the forward for a known fleet, a synthetic request of that fleet with
the anchor grid its boxes decode against, and a numpy request batch
moved to the device with the bfloat16 server's casts."""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import tracing

PROD_RANGE = [-102.4, -102.4, -3.0, 102.4, 102.4, 1.0]

# The production model (the port's copy of ``bench.py``'s ``PROD_CFG``):
# PointPillars on a 512^2 grid, ResNet-50 + FPN + planar BEVFormer at
# 128^2 x 256, 2 H3GAT iterations with the fusion kernels in bfloat16.
PROD_CFG = {
    "lidar": {
        "voxel_size": [0.4, 0.4, 4.0],
        "lidar_range": PROD_RANGE,
        "anchor_number": 2,
        "pillar_vfe": {"use_norm": True, "with_distance": False,
                       "use_absolute_xyz": True, "num_filters": [64]},
        "point_pillar_scatter": {"num_features": 64,
                                 "grid_size": [512, 512, 1]},
        "base_bev_backbone": {
            "layer_nums": [3, 5, 8],
            "layer_strides": [2, 2, 2],
            "num_filters": [64, 128, 256],
            "upsample_strides": [1, 2, 4],
            "num_upsample_filter": [128, 128, 128],
        },
        "shrink_header": {"kernal_size": [3], "stride": [2], "padding": [1],
                          "dim": [256], "input_dim": 384},
    },
    "camera": {"encoder": "bevformer", "lift": "planar",
               "backbone": "resnet50", "id_pick": [2, 3, 4],
               "fpn": True, "fpn_channels": 256,
               "dim": 256, "bev_size": 128, "out_dim": 256,
               "num_layers": 3, "heads": 8, "window": 8,
               "num_points_in_pillar": 4, "decoder_layers": 0,
               "bev_range": 102.4},
    "compression": 0,
    "hetero_fusion": {
        "num_iters": 2,
        "hetero_fusion_block": {
            "spatial_transform": {"downsample_rate": 4,
                                  "voxel_size": [0.4, 0.4, 4.0]},
            "architect_mode": "sequential",
            "input_dim": 256,
            "mlp_dim": 256,
            "window_size": 8,
            "dim_head": 32,
            "drop_out": 0.0,
            "compute_dtype": "bfloat16",
        },
    },
    "hetero_decoder": {"input_dim": 256, "num_layer": 2,
                       "num_ch_dec": [256, 256], "anchor_number": 2},
}

# kept in float32 by a bfloat16 server: calibration, geometry and raw
# lidar points (bf16 coordinates quantize to ~0.4 m at 100 m range)
GEOMETRY_KEYS = frozenset({"pairwise_t_matrix", "transformation_matrix",
                           "intrinsics", "extrinsics",
                           "spatial_correction_matrix", "points"})


def serving_config(cfg: dict, bf16: bool, fused_wa: bool = False,
                   stripe: bool = True, expand: str | None = None) -> dict:
    """A deep copy of ``cfg`` (e.g. :data:`PROD_CFG`), which stays as it
    is.  ``bf16=True`` also casts the lidar features and the decoder to
    bfloat16, as the bfloat16 server does; ``bf16=False`` runs the
    fusion kernels in float32.  ``fused_wa=True`` sends the local fusion
    phases through the fused warp + attention kernel
    (``use_fused_wa``); ``stripe=False`` sends them through the window
    split and the plain attention kernel (``use_stripe``).
    ``expand="v1"`` or ``"v2"`` builds the lidar encoder's dense grid with
    that expansion kernel (``lidar.scatter_variant``) instead of the scan
    + row gather."""
    if expand not in (None, "v1", "v2"):
        raise ValueError(f"expand must be None, 'v1' or 'v2', got {expand!r}")
    cfg = copy.deepcopy(cfg)
    blk = cfg["hetero_fusion"]["hetero_fusion_block"]
    if bf16:
        cfg["lidar"]["compute_dtype"] = "bfloat16"
        cfg["hetero_decoder"]["compute_dtype"] = "bfloat16"
    else:
        blk["compute_dtype"] = "float32"
    if fused_wa:
        blk["use_fused_wa"] = True
    if not stripe:
        blk["use_stripe"] = False
    if expand:
        cfg["lidar"]["scatter_variant"] = expand
    return cfg


def serving_hints(mode_row, num_agents: int, batch_size: int = 1) -> dict:
    """Static hints of :meth:`HMViT.forward` for a batch of
    ``batch_size`` fleets whose first ``num_agents`` slots have the
    modalities ``mode_row`` (the camera bucket counts the cameras of the
    whole batch, as ``bench.py``'s does)."""
    fleet = tuple(int(m) for m in mode_row[:num_agents])
    return dict(camera_bucket=batch_size * sum(m == 0 for m in fleet),
                active_agents=num_agents, static_ego_modality=fleet[0],
                static_modes=fleet)


def request_batch(seed: int, num_agents: int = 4, max_points: int = 30000,
                  image_size: int = 512, num_cams: int = 4,
                  lidar_range=PROD_RANGE, batch_size: int = 1):
    """One synthetic request of ``batch_size`` fleets: ``num_agents``
    agents in 5 slots, alternating lidar / camera from a lidar ego; the
    defaults are the production request (30 000 point slots per lidar
    agent, 4 x 512^2 images per camera agent)."""
    from .data.synthetic import make_hetero_batch

    batch, _ = make_hetero_batch(
        seed=seed, batch_size=batch_size, max_cav=5, num_agents=num_agents,
        max_points=max_points,
        image_size=image_size, num_cams=num_cams, camera_ratio=0.5,
        ego_mode="mixed", lidar_range=lidar_range)
    for i in range(num_agents):
        batch["mode"][:, i] = (i + 1) % 2
    return batch


def anchor_args(cfg: dict) -> dict:
    """The anchor grid of a model configuration's lidar geometry at
    feature stride 4 (the production model: 512^2 pillars, 128^2 BEV)."""
    lidar = cfg["lidar"]
    grid = lidar["point_pillar_scatter"]["grid_size"]
    return {"W": grid[0], "H": grid[1], "l": 3.9, "w": 1.6, "h": 1.56,
            "r": [0, 90], "num": 2, "feature_stride": 4,
            "vw": lidar["voxel_size"][0], "vh": lidar["voxel_size"][1],
            "cav_lidar_range": lidar["lidar_range"]}


def batch_to_device(batch, device, bf16: bool):
    """numpy batch -> tensors on ``device``; with ``bf16``, every float32
    array but the geometry in bfloat16.  With the tracer on, the
    ``request`` span, which starts the next frame or step id."""
    out = {}
    with tracing.span("request", new_unit=True):
        for k, v in batch.items():
            t = torch.from_numpy(np.asarray(v)).to(device)
            if bf16 and t.dtype == torch.float32 and k not in GEOMETRY_KEYS:
                t = t.to(torch.bfloat16)
            out[k] = t
    return out
