"""Single-agent PointPillars detector, the lidar-only family (port of
``hmvit_tpu/models/point_pillar.py``): the encoder of the fusion models'
lidar branch -> 1x1 anchor heads, or the bare features with
``return_features``.
"""
from __future__ import annotations

from torch import nn

from .layers import DetectionHead
from .pillar_encoder import PointPillarEncoder


class PointPillarDetector(nn.Module):
    def __init__(self, config: dict, return_features: bool = False):
        super().__init__()
        self.return_features = return_features
        self.PointPillarEncoder_0 = PointPillarEncoder(config)
        self.DetectionHead_0 = None
        if not return_features:
            self.DetectionHead_0 = DetectionHead(
                self.PointPillarEncoder_0.out_channels,
                config["anchor_number"])

    def forward(self, points, points_mask=None):
        """points (N, P, 4), points_mask (N, P) -> features (N, H, W, C)
        or {"psm": (N, A, H, W), "rm": (N, 7A, H, W)}.  ``points`` may
        also be a batch of the run-directory tools (a dict with
        (B, L, P, 4) ``points`` and (B, L, P) ``points_mask``): its ego
        slot is the input.  (The JAX module takes the arrays alone, so
        the JAX tools cannot run it.)"""
        if isinstance(points, dict):
            points, points_mask = (points["points"][:, 0],
                                   points["points_mask"][:, 0])
        x = self.PointPillarEncoder_0(points, points_mask)
        if self.return_features:
            return x
        psm, rm = self.DetectionHead_0(x)
        return {"psm": psm.permute(0, 3, 1, 2), "rm": rm.permute(0, 3, 1, 2)}
