"""Camera backbone factory (port of the ResNet branch of
``hmvit_tpu/models/cvt.py::make_image_backbone``)."""
from __future__ import annotations

from .resnet import ResNetEncoder


def make_image_backbone(cfg: dict) -> ResNetEncoder:
    """Image backbone named by ``cfg["backbone"]`` (ResNet only)."""
    backbone = cfg.get("backbone")
    if not backbone or not backbone.startswith("resnet"):
        raise ValueError(f"camera backbone {backbone!r} is not ported")
    if cfg.get("stem_s2d"):
        raise ValueError("the space-to-depth stem is not ported")
    return ResNetEncoder(arch=backbone,
                         id_pick=tuple(cfg.get("id_pick", (3,))))
