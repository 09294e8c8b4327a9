"""PIXOR, the anchor-free single-shot BEV detector (port of
``hmvit_tpu/models/pixor.py``): an occupancy + intensity raster of the
cloud (:func:`bev_raster`), a bottleneck ResNet trunk [3, 6, 6, 3] with
a lateral / top-down neck to a quarter of the raster
(:class:`PixorBackbone`) and a header of a 1-channel objectness map and
a 6-channel regression map (cos yaw, sin yaw, dx, dy, log w, log l;
:class:`PixorHeader`).  The cooperative variant fuses c3 / c4 / c5
across the agents by agent attention (:class:`PixorIntermediate`).

Layouts: the raster is (B, nx, ny, nz + 1), x before y, unlike the
anchor models' (ny, nx) BEV; the outputs ``cls`` / ``reg`` are NCHW.
The raster is three scatter-adds (occupancy, intensity, count): on a
CUDA device the intensity sums add in no fixed order, so they may differ
in their last bits between runs; the occupancy adds of 1.0 are exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Conv, ConvTranspose
from .fusion.basic import AttFusion


class FlaxNames:
    """Registers children under flax's automatic names: each class
    numbered on its own, in the order of creation."""

    def __init__(self, owner: nn.Module):
        self.owner, self.count = owner, {}

    def __call__(self, module: nn.Module, kind: str | None = None):
        kind = kind or type(module).__name__
        i = self.count.get(kind, 0)
        self.count[kind] = i + 1
        self.owner.add_module(f"{kind}_{i}", module)
        return module


def geometry_from_config(cfg: dict) -> dict:
    """The BEV geometry of ``res``, ``downsample_rate`` (4) and
    ``cav_lidar_range`` (the config loader's ``load_bev_params``)."""
    res = float(cfg["res"])
    L1, W1, H1, L2, W2, H2 = [float(v) for v in cfg["cav_lidar_range"]]
    ds = int(cfg.get("downsample_rate", 4))
    nx = int((L2 - L1) / res)
    ny = int((W2 - W1) / res)
    nz = int((H2 - H1) / res)
    return {
        "L1": L1, "L2": L2, "W1": W1, "W2": W2, "H1": H1, "H2": H2,
        "res": res, "downsample_rate": ds,
        "input_shape": (nx, ny, nz + 1),
        "label_shape": (nx // ds, ny // ds, 7),
    }


def geometry_of(cfg: dict) -> dict:
    """A PIXOR model config's geometry: its ``geometry_param``, else from
    ``res`` (0.4), ``downsample_rate`` and ``lidar_range``."""
    return cfg.get("geometry_param") or geometry_from_config(
        {"res": cfg.get("res", 0.4),
         "downsample_rate": cfg.get("downsample_rate", 4),
         "cav_lidar_range": cfg["lidar_range"]})


def bev_raster(points, points_mask, geometry: dict):
    """points (B, P, 4) xyzr, points_mask (B, P) -> (B, nx, ny, nz + 1)
    float32: occupancy (0 / 1) of each z slice and the mean intensity of
    each column; padded and out-of-range points land in one overflow slot
    that is dropped."""
    nx, ny, nzc = geometry["input_shape"]
    nz = nzc - 1
    res = geometry["res"]
    b, p = points_mask.shape

    def cell(axis, lo):
        return torch.floor((points[..., axis] - lo) / res).to(torch.int64)

    ix, iy, iz = cell(0, geometry["L1"]), cell(1, geometry["W1"]), \
        cell(2, geometry["H1"])
    valid = ((points_mask > 0) & (ix >= 0) & (ix < nx) & (iy >= 0)
             & (iy < ny) & (iz >= 0) & (iz < nz))
    col = ix * ny + iy
    occ_idx = torch.where(valid, col * nz + iz, nx * ny * nz)
    col_idx = torch.where(valid, col, nx * ny)
    f32 = torch.float32
    w = valid.to(f32)
    occ = torch.zeros((b, nx * ny * nz + 1), dtype=f32, device=w.device)
    occ = occ.scatter_add(1, occ_idx, torch.ones_like(w))
    occ = torch.clamp(occ[:, :-1], max=1.0).reshape(b, nx, ny, nz)
    inten = torch.zeros((b, nx * ny + 1), dtype=f32, device=w.device)
    inten = inten.scatter_add(1, col_idx, (points[..., 3] * w).to(f32))
    cnt = torch.zeros((b, nx * ny + 1), dtype=f32, device=w.device)
    cnt = cnt.scatter_add(1, col_idx, w)
    mean = (inten / torch.clamp(cnt, min=1.0))[:, :-1].reshape(b, nx, ny, 1)
    return torch.cat([occ, mean], dim=-1)


def _bn(use_bn: bool, c: int):
    return BatchNorm(c, 1e-5, momentum=0.9) if use_bn else None


def _apply(bn, x):
    return x if bn is None else bn(x)


class PixorBottleneck(nn.Module):
    """Pre-expansion bottleneck: 1x1, 3x3 (stride), 1x1 to 4 x planes,
    each with BatchNorm (eps 1e-5) when ``use_bn`` (else the convs carry a
    bias), a strided 1x1 projection of the residual when ``downsample``."""

    def __init__(self, cin: int, planes: int, stride: int = 1,
                 use_bn: bool = True, downsample: bool = False):
        super().__init__()
        bias = not use_bn
        self.Conv_0 = Conv(cin, planes, 1, use_bias=bias)
        self.Conv_1 = Conv(planes, planes, 3, stride, padding=1,
                           use_bias=bias)
        self.Conv_2 = Conv(planes, 4 * planes, 1, use_bias=bias)
        self.Conv_3 = (Conv(cin, 4 * planes, 1, stride, use_bias=bias)
                       if downsample else None)
        for i in range(4 if downsample else 3):
            if use_bn:
                self.add_module(f"BatchNorm_{i}",
                                _bn(True, 4 * planes if i >= 2 else planes))
        self.bns = [getattr(self, f"BatchNorm_{i}", None) for i in range(4)]

    def forward(self, x):
        bn = self.bns
        out = F.relu(_apply(bn[0], self.Conv_0(x)))
        out = F.relu(_apply(bn[1], self.Conv_1(out)))
        out = _apply(bn[2], self.Conv_2(out))
        residual = x
        if self.Conv_3 is not None:
            residual = _apply(bn[3], self.Conv_3(x))
        return F.relu(residual + out)


class TorchConvT(nn.Module):
    """PyTorch's ``ConvTranspose2d(k, s, p, output_padding=op)`` on NHWC
    (the JAX package's ``_TorchConvT``: a flax ``ConvTranspose`` with the
    lax padding ``(k-1-p, k-1-p+op)``), with bias."""

    def __init__(self, cin: int, features: int, kernel: int, stride: int,
                 pad: int, out_pad: tuple = (0, 0)):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(cin, features, kernel, stride,
                                             use_bias=True, padding=pad,
                                             output_padding=out_pad)

    def forward(self, x):
        return self.ConvTranspose_0(x)


class PixorBackbone(nn.Module):
    """Bottleneck trunk + lateral / top-down neck; the output (N, H/4,
    W/4, 96).  ``fuse`` (the cooperative variant), when given to the
    forward, maps each agent-stacked c5 / c4 / c3 (index 0 / 1 / 2) to
    the fused ego map."""

    def __init__(self, cin: int, use_bn: bool = True,
                 num_blocks=(3, 6, 6, 3), out_pad2=(1, 1)):
        super().__init__()
        self.Conv_0 = Conv(cin, 32, 3, padding=1, use_bias=False)
        self.Conv_1 = Conv(32, 32, 3, padding=1, use_bias=False)
        self.BatchNorm_0, self.BatchNorm_1 = _bn(use_bn, 32), _bn(use_bn, 32)
        name = FlaxNames(self)
        self.stages = []
        cin = 32
        for planes, n in zip((24, 48, 64, 96), num_blocks):
            blocks = [name(PixorBottleneck(cin, planes, 2, use_bn, True))]
            cin = 4 * planes
            blocks += [name(PixorBottleneck(cin, planes, 1, use_bn))
                       for _ in range(1, n)]
            self.stages.append(blocks)
        self.Conv_2 = Conv(384, 196, 1)
        self.Conv_3 = Conv(256, 128, 1)
        self._TorchConvT_0 = TorchConvT(196, 128, 3, 2, 1, (1, 1))
        self.Conv_4 = Conv(192, 96, 1)
        self._TorchConvT_1 = TorchConvT(128, 96, 3, 2, 1, tuple(out_pad2))
        self.out_channels = 96

    def forward(self, x, fuse=None):
        x = F.relu(_apply(self.BatchNorm_0, self.Conv_0(x)))
        x = F.relu(_apply(self.BatchNorm_1, self.Conv_1(x)))
        cs = []
        for blocks in self.stages:
            for blk in blocks:
                x = blk(x)
            cs.append(x)
        _, c3, c4, c5 = cs
        if fuse is not None:
            c5, c4, c3 = fuse(c5, 0), fuse(c4, 1), fuse(c3, 2)
        p5 = self.Conv_3(c4) + self._TorchConvT_0(self.Conv_2(c5))
        return self.Conv_4(c3) + self._TorchConvT_1(p5)


class PixorHeader(nn.Module):
    """4 x (3x3 conv + BatchNorm, no activation) and the 3x3 heads: cls
    (1 channel, bias 0) and reg (6 channels, kernel 0 at init)."""

    def __init__(self, cin: int = 96, use_bn: bool = True):
        super().__init__()
        self.layers = []
        for i in range(4):
            conv = Conv(cin if i == 0 else 96, 96, 3, padding=1,
                        use_bias=not use_bn)
            bn = _bn(use_bn, 96)
            self.add_module(f"Conv_{i}", conv)
            if bn is not None:
                self.add_module(f"BatchNorm_{i}", bn)
            self.layers.append((conv, bn))
        self.Conv_4 = Conv(96, 1, 3, padding=1)
        self.Conv_5 = Conv(96, 6, 3, padding=1)

    def reset_parameters(self, gen):
        nn.init.zeros_(self.Conv_5.weight)

    def forward(self, x):
        for conv, bn in self.layers:
            x = _apply(bn, conv(x))
        return self.Conv_4(x), self.Conv_5(x)


def _maps(cls, reg) -> dict:
    return {"cls": cls.permute(0, 3, 1, 2), "reg": reg.permute(0, 3, 1, 2)}


class PIXORDetector(nn.Module):
    """PIXOR on one cloud per row: raster -> backbone -> header.  Returns
    {"cls": (N, 1, H/4, W/4), "reg": (N, 6, H/4, W/4)} logits (decoded by
    :mod:`hmvit_tpu_torch.postprocess_bev`), or the backbone's (N, H/4,
    W/4, 96) features with ``return_features``.  A new model is in eval
    mode."""

    def __init__(self, config: dict, return_features: bool = False):
        super().__init__()
        cfg = config
        self.return_features = return_features
        self.geometry = geometry_of(cfg)
        use_bn = cfg.get("use_bn", True)
        self.PixorBackbone_0 = PixorBackbone(self.geometry["input_shape"][2],
                                             use_bn)
        self.out_channels = self.PixorBackbone_0.out_channels
        self.PixorHeader_0 = (None if return_features
                              else PixorHeader(self.out_channels, use_bn))
        self.eval()

    def forward(self, points, points_mask):
        feats = self.PixorBackbone_0(bev_raster(points, points_mask,
                                                self.geometry))
        if self.return_features:
            return feats
        return _maps(*self.PixorHeader_0(feats))


class PixorIntermediate(nn.Module):
    """Cooperative PIXOR: each agent's trunk, agent attention at c5 / c4 /
    c3 (strides 16 / 8 / 4 of the raster) in the ego frame, the shared
    neck and header.  Takes the batch (``points`` (B, L, P, 4),
    ``points_mask``, ``agent_mask``, ``pairwise_t_matrix``) and returns
    the ego's maps (B, 1 | 6, H/4, W/4).  A new model is in eval mode."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        self.geometry = geometry_of(cfg)
        use_bn = cfg.get("use_bn", True)
        self.PixorBackbone_0 = PixorBackbone(self.geometry["input_shape"][2],
                                             use_bn)
        self.PixorHeader_0 = PixorHeader(96, use_bn)
        # parameterless: c5, c4, c3
        self.fusions = [AttFusion(dim, discrete_ratio=self.geometry["res"],
                                  downsample_rate=float(16 >> i))
                        for i, dim in enumerate((384, 256, 192))]
        self.eval()

    def forward(self, batch: dict) -> dict:
        points, pmask = batch["points"], batch["points_mask"]
        b, l = points.shape[:2]
        agent_mask = batch["agent_mask"]
        x = bev_raster(points.reshape(b * l, *points.shape[2:]),
                       pmask.reshape(b * l, -1), self.geometry)

        def fuse(maps, idx):
            per_agent = maps.reshape(b, l, *maps.shape[1:])
            per_agent = per_agent * agent_mask[:, :, None, None, None]
            return self.fusions[idx](per_agent, batch.get("mode"),
                                     batch["pairwise_t_matrix"], agent_mask)

        feats = self.PixorBackbone_0(x, fuse=fuse)
        return _maps(*self.PixorHeader_0(feats))
