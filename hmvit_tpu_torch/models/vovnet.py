"""VoVNet image backbone (One-Shot Aggregation) on NHWC (port of
``hmvit_tpu/models/vovnet.py``).

Each OSA module runs a chain of 3x3 conv-BN-ReLUs and concatenates its
input and every intermediate output once, then a 1x1 aggregation and an
eSE channel gate (a plain sigmoid over a 1x1 conv of the global average);
stages downsample by an XLA 'SAME' max-pool (-inf padding).  BatchNorm
keeps flax's eps 1e-5, with momentum 0.9, as the ResNet does.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Conv, max_pool_same
from .resnet import _BN_EPS, _BN_MOMENTUM

# arch: (stage channels, concat-out channels, convs per OSA, OSA blocks)
_ARCHS = {
    "vovnet-19": ([64, 80, 96, 112], [112, 256, 384, 512], 3,
                  [1, 1, 1, 1]),
    "vovnet-39": ([128, 160, 192, 224], [256, 512, 768, 1024], 5,
                  [1, 1, 2, 2]),
    "vovnet-57": ([128, 160, 192, 224], [256, 512, 768, 1024], 5,
                  [1, 1, 4, 3]),
}


class _ConvBN(nn.Module):
    """Bias-free conv ('SAME') + BatchNorm + ReLU."""

    def __init__(self, cin: int, ch: int, k: int = 3):
        super().__init__()
        self.Conv_0 = Conv(cin, ch, k, use_bias=False)
        self.BatchNorm_0 = BatchNorm(ch, _BN_EPS, _BN_MOMENTUM)

    def forward(self, x):
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class _ESE(nn.Module):
    """Effective squeeze-excite: x * sigmoid(conv1x1(mean over H, W))."""

    def __init__(self, ch: int):
        super().__init__()
        self.Conv_0 = Conv(ch, ch, 1)

    def forward(self, x):
        gate = self.Conv_0(x.mean(dim=(1, 2), keepdim=True))
        return x * torch.sigmoid(gate)


class _OSA(nn.Module):
    def __init__(self, cin: int, stage_ch: int, concat_ch: int,
                 n_convs: int, identity: bool = False):
        super().__init__()
        # the chain of 3x3 blocks, then the 1x1 aggregation
        self.blocks = []
        ch = cin
        for i in range(n_convs + 1):
            last = i == n_convs
            blk = (_ConvBN(cin + n_convs * stage_ch, concat_ch, k=1) if last
                   else _ConvBN(ch, stage_ch))
            self.add_module(f"_ConvBN_{i}", blk)
            self.blocks.append(blk)
            ch = stage_ch
        self._ESE_0 = _ESE(concat_ch)
        self.identity = identity and cin == concat_ch

    def forward(self, x):
        outs = [x]
        for blk in self.blocks[:-1]:
            outs.append(blk(outs[-1]))
        out = self._ESE_0(self.blocks[-1](torch.cat(outs, dim=-1)))
        return out + x if self.identity else out


class VoVNet(nn.Module):
    """(N, H, W, 3) -> the stage outputs picked by ``id_pick`` (1-4,
    strides 4/8/16/32): one array, or a list for several."""

    def __init__(self, arch: str = "vovnet-39",
                 id_pick: Sequence[int] = (3,)):
        super().__init__()
        if arch not in _ARCHS:
            raise ValueError(f"unknown VoVNet {arch!r} (the port builds "
                             f"{sorted(_ARCHS)})")
        stage_ch, concat_ch, n_convs, blocks = _ARCHS[arch]
        self.id_pick = tuple(id_pick)
        self.stage_channels = list(concat_ch)
        # stem: 3 convs, stride 2, 1, 2
        self.Conv_0 = Conv(3, 64, 3, 2, use_bias=False)
        self.BatchNorm_0 = BatchNorm(64, _BN_EPS, _BN_MOMENTUM)
        self._ConvBN_0 = _ConvBN(64, 64)
        self.Conv_1 = Conv(64, 128, 3, 2, use_bias=False)
        self.BatchNorm_1 = BatchNorm(128, _BN_EPS, _BN_MOMENTUM)
        self.stages = []
        cin, k = 128, 0
        for stage in range(4):
            osas = []
            for b in range(blocks[stage]):
                osa = _OSA(cin, stage_ch[stage], concat_ch[stage], n_convs,
                           identity=b > 0)
                self.add_module(f"_OSA_{k}", osa)
                osas.append(osa)
                cin = concat_ch[stage]
                k += 1
            self.stages.append(osas)

    @property
    def picked_channels(self) -> list[int]:
        return [self.stage_channels[i - 1] for i in self.id_pick]

    @property
    def halvings(self) -> int:
        """How many times the last picked stage halves the input."""
        return 1 + self.id_pick[-1]

    def forward(self, x):
        x = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        x = self._ConvBN_0(x)
        x = F.relu(self.BatchNorm_1(self.Conv_1(x)))
        outs = []
        for stage, osas in enumerate(self.stages):
            if stage > 0:
                x = max_pool_same(x, 3, 2)
            for osa in osas:
                x = osa(x)
            outs.append(x)
        picked = [outs[i - 1] for i in self.id_pick]
        return picked[0] if len(picked) == 1 else picked
