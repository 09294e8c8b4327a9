"""LiDAR branch: PointPillars encoder -> dense BEV features (port of
``hmvit_tpu/models/pillar_encoder.py``).

raw padded points (N, P, 4) -> pillarize -> per-point PFN (Dense +
masked BN + ReLU) -> max scatter into the (ny, nx, C) grid -> 2D BEV
backbone with transposed-conv up-fusion -> shrink conv.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import DTYPES, BatchNorm, ConvTranspose, Dense
from ..ops.voxelize import (
    pillar_point_features,
    pillarize,
    scan_steps,
    scatter_max_to_bev,
    segmented_run_totals,
)
from .layers import ConvBNReLU, DownsampleConv, MaskedBatchNorm


class PillarFeatureNet(nn.Module):
    """Per-point MLP + max-pool scatter over the whole fleet's clouds.

    compute_dtype: the voxelizer's coordinate math stays in the points'
    dtype (float32 — bf16 coordinates quantize to ~0.4 m at 100 m); the
    assembled per-point features are cast to it."""

    def __init__(self, num_filters: Sequence[int], voxel_size, pc_range,
                 grid_size, max_points_per_pillar: int = 32,
                 use_absolute_xyz: bool = True, with_distance: bool = False,
                 compute_dtype: str | None = None):
        super().__init__()
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.grid = (int(grid_size[0]), int(grid_size[1]))
        self.max_points_per_pillar = max_points_per_pillar
        self.use_absolute_xyz = use_absolute_xyz
        self.with_distance = with_distance
        self.compute_dtype = (None if compute_dtype is None
                              else DTYPES[compute_dtype])
        cin = (4 if use_absolute_xyz else 1) + 6 + int(with_distance)
        self.layers = []
        for i, out_ch in enumerate(num_filters):
            last = i == len(num_filters) - 1
            units = out_ch if last else out_ch // 2
            dense = Dense(cin, units, use_bias=False)
            bn = MaskedBatchNorm(units)
            self.add_module(f"Dense_{i}", dense)
            self.add_module(f"MaskedBatchNorm_{i}", bn)
            self.layers.append((dense, bn))
            cin = out_ch

    def forward(self, points, points_mask):
        """points (N, P, 4), points_mask (N, P) -> BEV (N, ny, nx, C)."""
        n_clouds = points.shape[0]
        info = pillarize(points, points_mask, self.voxel_size, self.pc_range,
                         self.grid, self.max_points_per_pillar)
        feats = pillar_point_features(info, self.use_absolute_xyz,
                                      self.with_distance)
        if self.compute_dtype is not None:
            feats = feats.to(self.compute_dtype)
        keep = info["keep"]
        for i, (dense, bn) in enumerate(self.layers):
            feats = F.relu(bn(dense(feats)))
            feats = feats * keep[:, None].to(feats.dtype)
            if i < len(self.layers) - 1:
                # concat each pillar's max back onto its points
                steps = scan_steps(self.max_points_per_pillar,
                                   feats.shape[0])
                pid2 = torch.where(keep, info["pillar_id"], -1)
                neg = torch.where(keep[:, None], feats,
                                  torch.full((), float("-inf"),
                                             dtype=feats.dtype,
                                             device=feats.device))
                pmax = segmented_run_totals(neg, pid2, steps, torch.maximum,
                                            float("-inf"))
                pmax = torch.where(torch.isfinite(pmax), pmax,
                                   torch.zeros_like(pmax))
                pmax = pmax * keep[:, None].to(pmax.dtype)
                feats = torch.cat([feats, pmax], dim=-1)
        return scatter_max_to_bev(feats, info["pillar_id"], keep, self.grid,
                                  n_clouds, max_run=self.max_points_per_pillar)


class BEVBackbone(nn.Module):
    """Multi-scale 2D conv backbone with transposed-conv up-fusion."""

    def __init__(self, cin: int, layer_nums, layer_strides, num_filters,
                 upsample_strides, num_upsample_filters):
        super().__init__()
        self.stages = []
        k = 0
        for i, n_layers in enumerate(layer_nums):
            blocks = []
            for j in range(n_layers + 1):
                blk = ConvBNReLU(cin, num_filters[i],
                                 stride=layer_strides[i] if j == 0 else 1)
                self.add_module(f"ConvBNReLU_{k}", blk)
                blocks.append(blk)
                cin = num_filters[i]
                k += 1
            s = upsample_strides[i]
            if s < 1:
                raise ValueError("fractional upsample strides are not ported")
            up = ConvTranspose(cin, num_upsample_filters[i], s, s)
            bn = BatchNorm(num_upsample_filters[i], 1e-3)
            self.add_module(f"ConvTranspose_{i}", up)
            self.add_module(f"BatchNorm_{i}", bn)
            self.stages.append((blocks, up, bn))
        self.out_channels = sum(num_upsample_filters)

    def forward(self, x):
        ups = []
        for blocks, up, bn in self.stages:
            for blk in blocks:
                x = blk(x)
            ups.append(F.relu(bn(up(x))))
        return torch.cat(ups, dim=-1) if len(ups) > 1 else ups[0]


class PointPillarEncoder(nn.Module):
    """points (N, P, 4) + mask (N, P) -> BEV features (N, H', W', C)."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        vfe = cfg["pillar_vfe"]
        self.PillarFeatureNet_0 = PillarFeatureNet(
            num_filters=vfe["num_filters"], voxel_size=cfg["voxel_size"],
            pc_range=cfg["lidar_range"],
            grid_size=cfg["point_pillar_scatter"]["grid_size"][:2],
            use_absolute_xyz=vfe.get("use_absolute_xyz", True),
            with_distance=vfe.get("with_distance", False),
            compute_dtype=cfg.get("compute_dtype"))
        if not vfe.get("enforce_point_cap", True):
            raise ValueError("the cap-free pillar path is not ported")
        bb = cfg["base_bev_backbone"]
        self.BEVBackbone_0 = BEVBackbone(
            vfe["num_filters"][-1], bb["layer_nums"], bb["layer_strides"],
            bb["num_filters"], bb["upsample_strides"],
            bb["num_upsample_filter"])
        self.DownsampleConv_0 = None
        if "shrink_header" in cfg:
            sh = cfg["shrink_header"]
            self.DownsampleConv_0 = DownsampleConv(
                self.BEVBackbone_0.out_channels, sh["kernal_size"],
                sh["dim"], sh["stride"])

    def forward(self, points, points_mask):
        x = self.BEVBackbone_0(self.PillarFeatureNet_0(points, points_mask))
        if self.DownsampleConv_0 is not None:
            x = self.DownsampleConv_0(x)
        return x
