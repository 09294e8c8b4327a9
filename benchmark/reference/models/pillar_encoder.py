"""LiDAR branch: PointPillars encoder -> dense BEV features (port of
``hmvit_tpu/models/pillar_encoder.py``).

raw padded points (N, P, 4) -> pillarize -> per-point PFN (Dense +
masked BN + ReLU) -> max scatter into the (ny, nx, C) grid -> 2D BEV
backbone with transposed-conv up-fusion -> shrink conv; and the BEV
backbone with per-stage agent fusion of the intermediate lidar model
(:class:`AttBEVBackbone`).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import DTYPES, BatchNorm, Conv, ConvTranspose, Dense
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
    assembled per-point features are cast to it.
    enforce_cap: the per-pillar point cap needs the global sort; without
    it every in-range point takes part (no sort, unsorted segment ops).
    scatter_variant: the dense-grid build — False = scan + row gather,
    True / "v1" or "v2" = compaction + an expansion kernel of
    ``ops/expand.py`` (config key ``lidar.scatter_variant``).
    use_scan_kernel: the scatter's max-scan through the one-pass kernel
    of ``ops/segscan.py``.  No configuration key sets it, as none does in
    the JAX package; ``hmvit_tpu_torch.perf_lab`` is its entry point."""

    def __init__(self, num_filters: Sequence[int], voxel_size, pc_range,
                 grid_size, max_points_per_pillar: int = 32,
                 use_absolute_xyz: bool = True, with_distance: bool = False,
                 enforce_cap: bool = True, compute_dtype: str | None = None,
                 scatter_variant: bool | str = False,
                 use_scan_kernel: bool = False):
        super().__init__()
        self.enforce_cap = enforce_cap
        self.scatter_variant = scatter_variant
        self.use_scan_kernel = use_scan_kernel
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

    def point_features(self, points, points_mask):
        """points (N, P, 4), points_mask (N, P) -> the PFN's per-point
        features (N*P, C), zeroed for dropped points, and the
        :func:`pillarize` record they are ordered by."""
        n_clouds = points.shape[0]
        info = pillarize(points, points_mask, self.voxel_size, self.pc_range,
                         self.grid, self.max_points_per_pillar,
                         enforce_cap=self.enforce_cap)
        feats = pillar_point_features(info, self.use_absolute_xyz,
                                      self.with_distance)
        if self.compute_dtype is not None:
            feats = feats.to(self.compute_dtype)
        keep = info["keep"]
        for i, (dense, bn) in enumerate(self.layers):
            feats = F.relu(bn(dense(feats), keep))
            feats = feats * keep[:, None].to(feats.dtype)
            if i < len(self.layers) - 1:
                # concat each pillar's max back onto its points
                neg = torch.where(keep[:, None], feats,
                                  torch.full((), float("-inf"),
                                             dtype=feats.dtype,
                                             device=feats.device))
                if self.enforce_cap:
                    # sorted runs: per-point propagation, no scatter
                    steps = scan_steps(self.max_points_per_pillar,
                                       feats.shape[0])
                    pid2 = torch.where(keep, info["pillar_id"], -1)
                    pmax = segmented_run_totals(neg, pid2, steps,
                                                torch.maximum, float("-inf"))
                    pmax = torch.where(torch.isfinite(pmax), pmax,
                                       torch.zeros_like(pmax))
                    pmax = pmax * keep[:, None].to(pmax.dtype)
                else:
                    pid = info["pillar_id"]
                    cells = n_clouds * self.grid[0] * self.grid[1] + 1
                    pm = torch.full((cells, neg.shape[1]), float("-inf"),
                                    dtype=neg.dtype, device=neg.device)
                    pm = pm.scatter_reduce(
                        0, pid[:, None].expand(-1, neg.shape[1]), neg,
                        reduce="amax")
                    pmax = torch.where(torch.isfinite(pm), pm,
                                       torch.zeros_like(pm))[pid]
                feats = torch.cat([feats, pmax], dim=-1)
        return feats, info

    def forward(self, points, points_mask):
        """points (N, P, 4), points_mask (N, P) -> BEV (N, ny, nx, C)."""
        feats, info = self.point_features(points, points_mask)
        return scatter_max_to_bev(
            feats, info["pillar_id"], info["keep"], self.grid,
            info["num_clouds"],
            sorted_ids=self.enforce_cap,
            max_run=self.max_points_per_pillar if self.enforce_cap else None,
            use_expand_kernel=self.scatter_variant,
            use_scan_kernel=self.use_scan_kernel)


class BEVBackbone(nn.Module):
    """Multi-scale 2D conv backbone with transposed-conv up-fusion."""

    def __init__(self, cin: int, layer_nums, layer_strides, num_filters,
                 upsample_strides, num_upsample_filters):
        super().__init__()
        self.stages = []
        k = 0
        n_up = {"ConvTranspose": 0, "Conv": 0}
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
            if s >= 1:
                up = ConvTranspose(cin, num_upsample_filters[i], s, s)
            else:
                # a fractional stride shrinks: a strided convolution
                inv = int(round(1 / s))
                up = Conv(cin, num_upsample_filters[i], inv, inv,
                          use_bias=False)
            # flax numbers the modules of each class on their own
            kind = type(up).__name__
            self.add_module(f"{kind}_{n_up[kind]}", up)
            n_up[kind] += 1
            bn = BatchNorm(num_upsample_filters[i], 1e-3)
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


def pixel_agent_attention(x, agent_mask):
    """Per-pixel scaled dot-product attention across the agents, the
    ego's row returned (no learned projections): x (B, L, H, W, C),
    agent_mask (B, L) -> (B, H, W, C).  Scores in float32, the weighted
    sum in x's type."""
    sim = torch.einsum("bihwc,bjhwc->bhwij", x[:, :1].to(torch.float32),
                       x.to(torch.float32)) / math.sqrt(x.shape[-1])
    sim = torch.where(agent_mask[:, None, None, None, :] > 0, sim, -1e9)
    attn = torch.softmax(sim, dim=-1).to(x.dtype)
    return torch.einsum("bhwij,bjhwc->bihwc", attn, x)[:, 0]


class AttBEVBackbone(BEVBackbone):
    """:class:`BEVBackbone` with per-stage agent fusion: each stage's
    output is fused across the agents by :func:`pixel_agent_attention`,
    and the fused (ego) map feeds that stage's upsampling branch while
    the unfused maps go on to the next stage.  Its input is every
    agent's map already in the ego frame; its output the ego's fused
    multi-scale concatenation."""

    def forward(self, x, agent_mask):
        """x (B, L, H, W, C), agent_mask (B, L) -> (B, H', W', C')."""
        b, l = x.shape[:2]
        flat = x.reshape(b * l, *x.shape[2:])
        ups = []
        for blocks, up, bn in self.stages:
            for blk in blocks:
                flat = blk(flat)
            fused = pixel_agent_attention(
                flat.reshape(b, l, *flat.shape[1:]), agent_mask)
            ups.append(F.relu(bn(up(fused))))
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
            enforce_cap=vfe.get("enforce_point_cap", True),
            compute_dtype=cfg.get("compute_dtype"),
            scatter_variant=cfg.get("scatter_variant", False))
        bb = cfg["base_bev_backbone"]
        self.BEVBackbone_0 = BEVBackbone(
            vfe["num_filters"][-1], bb["layer_nums"], bb["layer_strides"],
            bb["num_filters"], bb["upsample_strides"],
            bb["num_upsample_filter"])
        self.DownsampleConv_0 = None
        self.out_channels = self.BEVBackbone_0.out_channels
        if "shrink_header" in cfg:
            sh = cfg["shrink_header"]
            self.DownsampleConv_0 = DownsampleConv(
                self.out_channels, sh["kernal_size"], sh["dim"], sh["stride"])
            self.out_channels = sh["dim"][-1]

    def forward(self, points, points_mask):
        x = self.BEVBackbone_0(self.PillarFeatureNet_0(points, points_mask))
        if self.DownsampleConv_0 is not None:
            x = self.DownsampleConv_0(x)
        return x
