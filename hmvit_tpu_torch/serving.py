"""Serving helpers for :class:`HMViT`: a model configuration's bfloat16
or float32 serving variant, the static hints a server passes to the
forward for a known fleet, and a numpy request batch moved to the
device with the bfloat16 server's casts."""
from __future__ import annotations

import copy

import numpy as np
import torch

# kept in float32 by a bfloat16 server: calibration, geometry and raw
# lidar points (bf16 coordinates quantize to ~0.4 m at 100 m range)
GEOMETRY_KEYS = frozenset({"pairwise_t_matrix", "transformation_matrix",
                           "intrinsics", "extrinsics",
                           "spatial_correction_matrix", "points"})


def serving_config(cfg: dict, bf16: bool) -> dict:
    """A deep copy of ``cfg`` (e.g. ``bench.PROD_CFG``), which stays as
    it is.  ``bf16=True`` also casts the lidar features and the decoder
    to bfloat16, as the bfloat16 server does; ``bf16=False`` runs the
    fusion kernels in float32."""
    cfg = copy.deepcopy(cfg)
    if bf16:
        cfg["lidar"]["compute_dtype"] = "bfloat16"
        cfg["hetero_decoder"]["compute_dtype"] = "bfloat16"
    else:
        cfg["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"] = \
            "float32"
    return cfg


def serving_hints(mode_row, num_agents: int) -> dict:
    """Static hints of :meth:`HMViT.forward` for a fleet whose first
    ``num_agents`` slots have the modalities ``mode_row``."""
    fleet = tuple(int(m) for m in mode_row[:num_agents])
    return dict(camera_bucket=sum(m == 0 for m in fleet),
                active_agents=num_agents, static_ego_modality=fleet[0],
                static_modes=fleet)


def batch_to_device(batch, device, bf16: bool):
    """numpy batch -> tensors on ``device``; with ``bf16``, every float32
    array but the geometry in bfloat16."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)).to(device)
        if bf16 and t.dtype == torch.float32 and k not in GEOMETRY_KEYS:
            t = t.to(torch.bfloat16)
        out[k] = t
    return out
