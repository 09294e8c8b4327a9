"""ResNet-50 image backbone and FPN on NHWC (port of
``hmvit_tpu/models/resnet.py``, XLA 'SAME' padding: stride-2 convs pad
(0, 1) at even sizes, the 7x7 stem and the max-pool pad the XLA way, and
BatchNorm keeps flax's default eps 1e-5, with momentum 0.9)."""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Conv, max_pool_same, resize_nearest

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        cout = features * 4
        self.Conv_0 = Conv(cin, features, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)
        self.Conv_1 = Conv(features, features, 3, stride, use_bias=False)
        self.BatchNorm_1 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)
        self.Conv_2 = Conv(features, cout, 1, use_bias=False)
        self.BatchNorm_2 = BatchNorm(cout, _BN_EPS, _BN_MOMENTUM)
        self.project = cin != cout or stride != 1
        if self.project:
            self.Conv_3 = Conv(cin, cout, 1, stride, use_bias=False)
            self.BatchNorm_3 = BatchNorm(cout, _BN_EPS, _BN_MOMENTUM)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.BatchNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


_ARCH = {"resnet50": (Bottleneck, (3, 4, 6, 3))}


class ResNetEncoder(nn.Module):
    """(N, H, W, 3) -> the stage outputs picked by ``id_pick`` (1-4,
    strides 4/8/16/32): one array, or a list for several."""

    def __init__(self, arch: str = "resnet50",
                 id_pick: Sequence[int] = (3,)):
        super().__init__()
        if arch not in _ARCH:
            raise ValueError(f"backbone {arch!r} is not ported")
        block, layout = _ARCH[arch]
        self.id_pick = tuple(id_pick)
        self.Conv_0 = Conv(3, 64, 7, 2, use_bias=False)
        self.BatchNorm_0 = BatchNorm(64, _BN_EPS, _BN_MOMENTUM)
        self.stages = []
        cin, features, k = 64, 64, 0
        for stage, n_blocks in enumerate(layout):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blk = block(cin, features, stride)
                self.add_module(f"{block.__name__}_{k}", blk)
                blocks.append(blk)
                cin = features * block.expansion
                k += 1
            self.stages.append(blocks)
            features *= 2
        self.stage_channels = [64 * block.expansion * 2 ** s
                               for s in range(len(layout))]

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = max_pool_same(x, 3, 2)
        outs = []
        for blocks in self.stages:
            for blk in blocks:
                x = blk(x)
            outs.append(x)
        picked = [outs[i - 1] for i in self.id_pick]
        return picked[0] if len(picked) == 1 else picked


class FPN(nn.Module):
    """Top-down feature pyramid: lateral 1x1 projections, nearest
    upsample + add, 3x3 smoothing.  Input and output ordered fine ->
    coarse."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256):
        super().__init__()
        self.n = len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"lateral{i}", Conv(cin, out_channels, 1))
            self.add_module(f"smooth{i}", Conv(out_channels, out_channels, 3))

    def forward(self, feats):
        lats = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        tops = [lats[-1]]
        for lat in lats[-2::-1]:
            tops.append(lat + resize_nearest(tops[-1], lat.shape[1:3]))
        tops = tops[::-1]
        return [getattr(self, f"smooth{i}")(t) for i, t in enumerate(tops)]
