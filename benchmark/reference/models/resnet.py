"""ResNet-18/34/50 image backbones and FPN on NHWC (port of
``hmvit_tpu/models/resnet.py``, XLA 'SAME' padding: stride-2 convs pad
(0, 1) at even sizes, the 7x7 stem and the max-pool pad the XLA way, and
BatchNorm keeps flax's default eps 1e-5, with momentum 0.9).  With
``torch_padding`` the grid is PyTorch's instead (the checkpoint-import
twins): the stem pads (3, 3), the max-pool (1, 1) with -inf and each
stride-2 3x3 conv (1, 1)."""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Conv, max_pool_same, resize_nearest

_BN_EPS = 1e-5
_BN_MOMENTUM = 0.9


def _pad3(stride: int, torch_padding: bool):
    """A 3x3 conv's padding: PyTorch's (1, 1) for a stride-2 conv under
    ``torch_padding``, else XLA 'SAME'."""
    return 1 if torch_padding and stride > 1 else "SAME"


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 torch_padding: bool = False):
        super().__init__()
        self.Conv_0 = Conv(cin, features, 3, stride,
                           padding=_pad3(stride, torch_padding),
                           use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)
        self.Conv_1 = Conv(features, features, 3, use_bias=False)
        self.BatchNorm_1 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)
        self.project = cin != features or stride != 1
        if self.project:
            self.Conv_2 = Conv(cin, features, 1, stride, use_bias=False)
            self.BatchNorm_2 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)

    def forward(self, x):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.BatchNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 torch_padding: bool = False):
        super().__init__()
        cout = features * 4
        self.Conv_0 = Conv(cin, features, 1, use_bias=False)
        self.BatchNorm_0 = BatchNorm(features, _BN_EPS, _BN_MOMENTUM)
        self.Conv_1 = Conv(features, features, 3, stride,
                           padding=_pad3(stride, torch_padding),
                           use_bias=False)
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


_ARCH = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
}


def s2d_stem(x, weight):
    """The 7x7 / 2 stem as a 4x4 / 1 convolution over the 2 x 2
    space-to-depth input (3 -> 12 channels), the same function: per axis,
    with XLA 'SAME' padding (2, 3),
      out[i] = sum_k K7[k] x[2i + k - 2]
             = sum_t sum_s K8[2t + s] X_s[i + t - 1],
    with K8 the 7 taps and a zero eighth, X_s the parity-s slice; so the
    4-tap convolution pads (1, 2).  ``weight`` is the plain stem's
    (64, 3, 7, 7), cast to the input's type as the JAX stem casts it."""
    k8 = F.pad(weight.to(x.dtype), (0, 1, 0, 1))  # (64, 3, 8, 8)
    cout, cin = k8.shape[:2]
    # (o, c, 4 ty, 2 sy, 4 tx, 2 sx) -> (o, sy, sx, c, ty, tx): the input
    # channel of parity slice (sy, sx) and colour c is (2 sy + sx) 3 + c
    k4 = k8.reshape(cout, cin, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4)
    k4 = k4.reshape(cout, 4 * cin, 4, 4)
    xs = torch.cat([x[:, sy::2, sx::2, :] for sy in (0, 1) for sx in (0, 1)],
                   dim=-1).permute(0, 3, 1, 2)
    y = F.conv2d(F.pad(xs, (1, 2, 1, 2)), k4)
    return y.permute(0, 2, 3, 1)


class ResNetEncoder(nn.Module):
    """(N, H, W, 3) -> the stage outputs picked by ``id_pick`` (1-4,
    strides 4/8/16/32): one array, or a list for several.  ``stem_s2d``
    runs the stem as :func:`s2d_stem`, on the same ``Conv_0`` weight, so
    a checkpoint serves both stems.  ``torch_padding`` pads on PyTorch's
    grid (the stem, the max-pool and the stride-2 convs; ``stem_s2d`` is
    then ignored, as in JAX)."""

    def __init__(self, arch: str = "resnet50",
                 id_pick: Sequence[int] = (3,), stem_s2d: bool = False,
                 torch_padding: bool = False):
        super().__init__()
        if arch not in _ARCH:
            raise ValueError(f"unknown ResNet {arch!r} (the port builds "
                             f"{sorted(_ARCH)})")
        block, layout = _ARCH[arch]
        self.id_pick = tuple(id_pick)
        self.stem_s2d = stem_s2d
        self.torch_padding = torch_padding
        self.Conv_0 = Conv(3, 64, 7, 2,
                           padding=3 if torch_padding else "SAME",
                           use_bias=False)
        self.BatchNorm_0 = BatchNorm(64, _BN_EPS, _BN_MOMENTUM)
        self.stages = []
        cin, features, k = 64, 64, 0
        for stage, n_blocks in enumerate(layout):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blk = block(cin, features, stride, torch_padding)
                self.add_module(f"{block.__name__}_{k}", blk)
                blocks.append(blk)
                cin = features * block.expansion
                k += 1
            self.stages.append(blocks)
            features *= 2
        self.stage_channels = [64 * block.expansion * 2 ** s
                               for s in range(len(layout))]

    @property
    def picked_channels(self) -> list[int]:
        return [self.stage_channels[i - 1] for i in self.id_pick]

    @property
    def halvings(self) -> int:
        """How many times the last picked stage halves the input."""
        return 1 + self.id_pick[-1]

    def forward(self, x):
        x = (s2d_stem(x, self.Conv_0.weight)
             if self.stem_s2d and not self.torch_padding else self.Conv_0(x))
        x = F.relu(self.BatchNorm_0(x))
        if self.torch_padding:
            # MaxPool2d(3, 2, padding=1): -inf padding on every side
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1)
            x = x.permute(0, 2, 3, 1)
        else:
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
