"""The other lidar detectors: VoxelNet and SECOND (port of
``hmvit_tpu/models/lidar_zoo.py``).

Both are dense: the sparse 3-D convolutions of the original networks are
3-D convolutions over the whole voxel grid (NDHWC, cuDNN's
channels-last-3d layout).  VoxelNet is a point MLP with a per-voxel max
(:class:`VoxelFeatureNet`), three 3-D conv middle layers
(:class:`VoxelCML`) and a multiscale 2-D RPN (:class:`VoxelRPN`);
SECOND is the per-voxel mean of the raw points (:func:`mean_voxel_grid`),
the dense twin of ``VoxelBackBone8x`` (:class:`VoxelBackbone8x`), z
folded into channels and the BEV backbone of PointPillars.

Each block keeps the JAX module's BatchNorm constants: ``eps`` 1e-5 and
flax momentum 0.9 in :class:`Conv3DBNReLU`, :class:`VoxelRPN` and the
PIXOR blocks; 1e-3 and 0.99 in :class:`VoxelBackbone8x`.  No kernel of
``csrc/`` runs here: the voxel max is the log-shift scan and a gather,
the voxel mean a segmented sum (no atomics: the same sums at every run).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Conv, Conv3D, Dense
from ..ops.voxelize import (
    last_kept_rows,
    pillar_point_features,
    pillarize,
    scan_steps,
    scatter_max_to_bev,
    segmented_scan,
)
from .fusion.basic import AttFusion
from .layers import DetectionHead, MaskedBatchNorm
from .pillar_encoder import BEVBackbone
from .pixor import FlaxNames, TorchConvT

# symmetric padding per axis (z, y, x): 1 everywhere, or z unpadded
_P1 = (1, 1, 1)
_Z_VALID = (0, 1, 1)


def _heads(psm, rm) -> dict:
    return {"psm": psm.permute(0, 3, 1, 2), "rm": rm.permute(0, 3, 1, 2)}


class Conv3DBNReLU(nn.Module):
    """3-D conv (with bias, as PyTorch's ``Conv3d``) + BatchNorm (eps
    1e-5, momentum 0.9) + ReLU."""

    def __init__(self, cin: int, features: int, stride=(1, 1, 1),
                 padding=_P1):
        super().__init__()
        self.Conv_0 = Conv3D(cin, features, stride=stride, padding=padding)
        self.BatchNorm_0 = BatchNorm(features, 1e-5, momentum=0.9)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class VoxelFeatureNet(nn.Module):
    """Point MLP (Dense + masked BatchNorm + ReLU) and a max per voxel
    into the dense (N, nz, ny, nx, C) grid."""

    def __init__(self, num_filters: int, voxel_size, pc_range, grid_size):
        super().__init__()
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.grid = tuple(int(g) for g in grid_size)
        self.Dense_0 = Dense(10, num_filters, use_bias=False)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(num_filters)

    def forward(self, points, points_mask):
        info = pillarize(points, points_mask, self.voxel_size,
                         self.pc_range, self.grid)
        keep = info["keep"]
        feats = self.MaskedBatchNorm_0(
            self.Dense_0(pillar_point_features(info)), keep)
        feats = F.relu(feats) * keep[:, None].to(feats.dtype)
        return scatter_max_to_bev(feats, info["pillar_id"], keep, self.grid,
                                  points.shape[0], max_run=32)


def cml_depth(nz: int) -> int:
    """The z cells left by :class:`VoxelCML` from ``nz``."""
    z = (nz + 2 - 3) // 2 + 1
    z -= 2
    return (z + 2 - 3) // 2 + 1


class VoxelCML(nn.Module):
    """Convolutional middle layers: z halved (stride 2, pad 1), z VALID,
    z halved again; 64 channels."""

    def __init__(self, cin: int):
        super().__init__()
        self.Conv3DBNReLU_0 = Conv3DBNReLU(cin, 64, stride=(2, 1, 1))
        self.Conv3DBNReLU_1 = Conv3DBNReLU(64, 64, padding=_Z_VALID)
        self.Conv3DBNReLU_2 = Conv3DBNReLU(64, 64, stride=(2, 1, 1))

    def forward(self, x):
        return self.Conv3DBNReLU_2(self.Conv3DBNReLU_1(self.Conv3DBNReLU_0(x)))


def fold_z_to_channels(x):
    """(N, nz, ny, nx, C) -> (N, ny, nx, C * nz), C outer and z inner (the
    channel order of PyTorch's ``view(N, C * D, H, W)``)."""
    n, nz, ny, nx, c = x.shape
    return x.permute(0, 2, 3, 4, 1).reshape(n, ny, nx, c * nz)


class VoxelRPN(nn.Module):
    """3-block multiscale RPN with transposed-conv concat fusion.  The
    JAX module's quirks stay: block 3's five trailing convs are raw (no
    BatchNorm or ReLU), the deconvolutions carry BatchNorm but no ReLU,
    the heads are bare 1x1 convs on the 768-channel concat."""

    def __init__(self, cin: int, anchor_num: int = 2):
        super().__init__()
        name = FlaxNames(self)
        self.b1, self.b2, self.b3 = [], [], []

        def cbr(blocks, ch, stride=1):
            nonlocal cin
            blocks.append((name(Conv(cin, ch, 3, stride, padding=1)),
                           name(BatchNorm(ch, 1e-5, momentum=0.9))))
            cin = ch

        for _ in range(4):
            cbr(self.b1, 128, 2 if not self.b1 else 1)
        for _ in range(6):
            cbr(self.b2, 128, 2 if not self.b2 else 1)
        cbr(self.b3, 256, 2)
        for _ in range(5):
            self.b3.append((name(Conv(256, 256, 3, padding=1)), None))
        self.ups = []
        for ch_in, k in ((256, 4), (128, 2), (128, 1)):
            up = name(TorchConvT(ch_in, 256, k, k, 0), "_TorchConvT")
            self.ups.append((up, name(BatchNorm(256, 1e-5, momentum=0.9))))
        # psm, rm (a list: the modules are registered under their flax
        # names only)
        self.heads = [name(Conv(768, anchor_num, 1)),
                      name(Conv(768, 7 * anchor_num, 1))]

    @staticmethod
    def _run(blocks, x):
        for conv, bn in blocks:
            x = conv(x) if bn is None else F.relu(bn(conv(x)))
        return x

    def forward(self, x):
        b1 = self._run(self.b1, x)
        b2 = self._run(self.b2, b1)
        b3 = self._run(self.b3, b2)
        cat = torch.cat([bn(up(y)) for (up, bn), y in
                         zip(self.ups, (b3, b2, b1))], dim=-1)
        return tuple(head(cat) for head in self.heads)


class VoxelNetDetector(nn.Module):
    """VoxelNet: VFE -> dense 3-D CML -> z folded -> multiscale RPN.
    Config: ``grid_size`` (nx, ny, nz), ``voxel_size``, ``lidar_range``,
    ``vfe_filters`` (64), ``anchor_number`` (2).  A new model is in eval
    mode."""

    def __init__(self, config: dict, return_features: bool = False):
        super().__init__()
        cfg = config
        self.return_features = return_features
        grid = cfg["grid_size"]
        vfe = cfg.get("vfe_filters", 64)
        self.VoxelFeatureNet_0 = VoxelFeatureNet(
            vfe, cfg["voxel_size"], cfg["lidar_range"], grid)
        self.VoxelCML_0 = VoxelCML(vfe)
        self.out_channels = 64 * cml_depth(int(grid[2]))
        self.VoxelRPN_0 = None
        if not return_features:
            self.VoxelRPN_0 = VoxelRPN(self.out_channels,
                                       cfg.get("anchor_number", 2))
        self.eval()

    def forward(self, points, points_mask):
        """points (N, P, 4), points_mask (N, P) -> the folded BEV (N, ny,
        nx, C) or {"psm": (N, A, H, W), "rm": (N, 7A, H, W)} at half the
        grid."""
        bev = fold_z_to_channels(self.VoxelCML_0(
            self.VoxelFeatureNet_0(points, points_mask)))
        if self.return_features:
            return bev
        return _heads(*self.VoxelRPN_0(bev))


def mean_voxel_grid(points, points_mask, voxel_size, pc_range, grid,
                    max_points_per_voxel: int = 5):
    """The mean of the raw point features (xyz, intensity) of each voxel,
    the first ``max_points_per_voxel`` points (input order) of it, in the
    dense (N, nz, ny, nx, 4) grid; 0 where a voxel holds none.  The sums
    are a segmented scan over the voxel-sorted points (no atomics)."""
    grid = tuple(int(g) for g in grid)
    n_clouds = points.shape[0]
    info = pillarize(points, points_mask, tuple(voxel_size),
                     tuple(pc_range), grid,
                     max_points_per_pillar=max_points_per_voxel)
    keep = info["keep"]
    keep_f = keep.to(info["points"].dtype)[:, None]
    vals = torch.cat([info["points"][:, :4] * keep_f, keep_f], dim=1)
    pid2 = torch.where(keep, info["pillar_id"], -1)
    sums = segmented_scan(vals, pid2, scan_steps(max_points_per_voxel,
                                                 vals.shape[0]),
                          torch.add, 0.0)
    nx, ny = grid[0], grid[1]
    nz = grid[2] if len(grid) > 2 else 1
    dense = last_kept_rows(sums, info["pillar_id"], keep,
                           n_clouds * nx * ny * nz)
    mean = dense[:, :4] / torch.clamp(dense[:, 4:], min=1.0)
    return mean.reshape(n_clouds, nz, ny, nx, 4)


class VoxelBackbone8x(nn.Module):
    """The dense twin of the sparse ``VoxelBackBone8x``: conv_input (16)
    -> conv1 (16) -> conv2 (s2 -> 32, 2 x 32) -> conv3 (s2 -> 64, 2 x
    64) -> conv4 (s2 with z unpadded -> 64, 2 x 64) -> conv_out (128,
    kernel (3, 1, 1), stride (2, 1, 1), unpadded).  Bias-free convs,
    BatchNorm eps 1e-3, momentum 0.99."""

    PLAN = ((16, (1, 1, 1), _P1), (16, (1, 1, 1), _P1),
            (32, (2, 2, 2), _P1), (32, (1, 1, 1), _P1),
            (32, (1, 1, 1), _P1), (64, (2, 2, 2), _P1),
            (64, (1, 1, 1), _P1), (64, (1, 1, 1), _P1),
            (64, (2, 2, 2), _Z_VALID), (64, (1, 1, 1), _P1),
            (64, (1, 1, 1), _P1))

    def __init__(self, cin: int = 4):
        super().__init__()
        self.blocks = []
        for i, (ch, stride, pad) in enumerate(self.PLAN):
            self.blocks.append(self._block(i, cin, ch, (3, 3, 3), stride,
                                           pad))
            cin = ch
        self.blocks.append(self._block(len(self.PLAN), cin, 128, (3, 1, 1),
                                       (2, 1, 1), (0, 0, 0)))

    def _block(self, i, cin, ch, kernel, stride, pad):
        conv = Conv3D(cin, ch, kernel, stride, pad, use_bias=False)
        bn = BatchNorm(ch, 1e-3, momentum=0.99)
        self.add_module(f"Conv_{i}", conv)
        self.add_module(f"BatchNorm_{i}", bn)
        return conv, bn

    def forward(self, x):
        for conv, bn in self.blocks:
            x = F.relu(bn(conv(x)))
        return x


def second_depth(nz: int) -> int:
    """The z cells :class:`VoxelBackbone8x` leaves of the ``nz + 1``
    cells SECOND feeds it."""
    z = nz + 1
    for pad, k in ((2, 3), (2, 3), (0, 3), (0, 3)):
        z = (z + pad - k) // 2 + 1
    return z


# SECOND's BEV backbone when the config has none
SECOND_BEV_BACKBONE = {
    "layer_nums": [5, 5], "layer_strides": [1, 2],
    "num_filters": [128, 256], "upsample_strides": [1, 2],
    "num_upsample_filter": [256, 256]}


class SecondDetector(nn.Module):
    """SECOND: voxel mean -> :class:`VoxelBackbone8x` -> z folded into
    channels -> BEV backbone -> 1x1 anchor heads.  Config: ``grid_size``
    (nx, ny, nz) with nz >= 24 (the z chain 41 -> 21 -> 11 -> 5 -> 2 of
    the reference's nz 40 must keep a cell), ``voxel_size``,
    ``lidar_range``, ``max_points_per_voxel`` (5), ``base_bev_backbone``,
    ``anchor_number`` (2).  The JAX module raises its ValueError on a
    collapsing z chain at its first call; the port at construction,
    where the channels of the BEV backbone are fixed.  A new model is in
    eval mode."""

    def __init__(self, config: dict, return_features: bool = False):
        super().__init__()
        cfg = config
        self.config, self.return_features = cfg, return_features
        grid = cfg["grid_size"]
        z = second_depth(int(grid[2]))
        if z < 1:
            raise ValueError(
                f"grid_size z={grid[2]} collapses VoxelBackbone8x's z "
                "chain to zero cells; use nz >= 24 (reference: 40)")
        self.VoxelBackbone8x_0 = VoxelBackbone8x()
        bb = cfg.get("base_bev_backbone", SECOND_BEV_BACKBONE)
        self.BEVBackbone_0 = BEVBackbone(
            128 * z, bb["layer_nums"], bb["layer_strides"], bb["num_filters"],
            bb["upsample_strides"], bb["num_upsample_filter"])
        self.out_channels = self.BEVBackbone_0.out_channels
        self.DetectionHead_0 = None
        if not return_features:
            self.DetectionHead_0 = DetectionHead(
                self.out_channels, cfg.get("anchor_number", 2))
        self.eval()

    def forward(self, points, points_mask):
        cfg = self.config
        vox = mean_voxel_grid(points, points_mask, cfg["voxel_size"],
                              cfg["lidar_range"], cfg["grid_size"],
                              cfg.get("max_points_per_voxel", 5))
        # the reference's sparse_shape appends one z cell
        vox = F.pad(vox, (0, 0, 0, 0, 0, 0, 0, 1))
        bev = self.BEVBackbone_0(fold_z_to_channels(
            self.VoxelBackbone8x_0(vox)))
        if self.return_features:
            return bev
        return _heads(*self.DetectionHead_0(bev))


class VoxelNetIntermediate(nn.Module):
    """Cooperative VoxelNet: each agent's VFE + CML, agent attention on
    the folded BEV in the ego frame, the shared RPN.  Takes the batch
    (``points`` (B, L, P, 4), ``points_mask``, ``agent_mask``,
    ``pairwise_t_matrix``).  A new model is in eval mode."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        grid = cfg["grid_size"]
        vfe = cfg.get("vfe_filters", 64)
        self.VoxelFeatureNet_0 = VoxelFeatureNet(
            vfe, cfg["voxel_size"], cfg["lidar_range"], grid)
        self.VoxelCML_0 = VoxelCML(vfe)
        c = 64 * cml_depth(int(grid[2]))
        self.AttFusion_0 = AttFusion(
            c, discrete_ratio=float(cfg["voxel_size"][0]),
            downsample_rate=1.0)
        self.VoxelRPN_0 = VoxelRPN(c, cfg.get("anchor_number", 2))
        self.eval()

    def forward(self, batch: dict) -> dict:
        points, pmask = batch["points"], batch["points_mask"]
        b, l = points.shape[:2]
        vox = self.VoxelFeatureNet_0(points.reshape(b * l, *points.shape[2:]),
                                     pmask.reshape(b * l, -1))
        bev = fold_z_to_channels(self.VoxelCML_0(vox))
        bev = bev.reshape(b, l, *bev.shape[1:])
        agent_mask = batch["agent_mask"]
        bev = bev * agent_mask[:, :, None, None, None]
        fused = self.AttFusion_0(bev, batch.get("mode"),
                                 batch["pairwise_t_matrix"], agent_mask)
        return _heads(*self.VoxelRPN_0(fused))
