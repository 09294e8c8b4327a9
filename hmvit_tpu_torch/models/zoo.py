"""Model registry: a model from its hypes ``model`` block (port of
``hmvit_tpu/models/zoo.py::build_model``).

The port builds the hetero (camera + lidar) assembly, :class:`HMViT`
with H3GAT fusion, under the JAX registry's names for it
(:data:`HETERO_NAMES`), with every camera encoder of the JAX package
but its reference twins (``models/hmvit.py::CAMERA_ENCODERS``: ``cvt``,
``fax``, ``bevformer`` with either lift, ``vpn``, ``vpn_ms``,
``bev_swap``) and the bandwidth compressor; a name that starts with
``fax_`` or ``bevformer_`` names the camera encoder, as in JAX.  So
every hetero hypes of the corpus builds.  Every other name of the JAX
registry (:data:`ZOO_NAMES`: the lidar-only, camera-only, segmentation
and other-fusion families) raises ``NotImplementedError``: the fusion
zoo, the camera-only and segmentation assemblies and the lidar zoo are
ROADMAP.md Queue 1 item 5.  An unknown name raises ``ValueError``, as
in JAX.
"""
from __future__ import annotations

from torch import nn

from .hmvit import HMViT

HETERO_NAMES = frozenset({
    "hmvit", "hetero_hmvit", "bevformer_point_pillar_hetero",
    "fax_point_pillar_hetero",
})
# the JAX registry's other names (its lidar, camera, VPN and mixed fusion
# tables and its single-model names)
ZOO_NAMES = frozenset({
    # lidar-only cooperative fusion
    "point_pillar_fcooper", "point_pillar_opv2v",
    "point_pillar_intermediate", "point_pillar_v2vnet",
    "point_pillar_disconet", "point_pillar_swap", "point_pillar_cobevt",
    "point_pillar_transformer", "point_pillar_v2xt",
    # camera-only cooperative fusion
    "cvt_fcooper", "cvt_att_fuse", "cvt_v2vnet", "cvt_disconet", "corpbevt",
    "cvt_swap_fuse", "cross_view_transformer_fcooper",
    "cross_view_transformer_att_fuse", "cross_view_transformer_v2vnet",
    "cross_view_transformer_disconet", "cross_view_transformer_swap_fuse",
    "cvt_v2xt", "v2xt_camera",
    "view_parse_network_att_fuse", "view_parse_network_fcooper",
    "view_parse_network_swap_fuse", "view_parse_network_v2vnet",
    # camera + lidar with another fusion than H3GAT
    "fax_point_pillar_fcooper", "fax_point_pillar_att_fuse",
    "fax_point_pillar_v2vnet", "fax_point_pillar_disconet",
    "fax_point_pillar_fax", "bevformer_point_pillar_fax",
    "fax_point_pillar_v2xt", "bevformer_point_pillar_v2xt",
    "bevformer_point_pillar_att_fuse", "bevformer_point_pillar_disconet",
    "bevformer_point_pillar_v2vnet",
    "point_pillar_cross_view_transformer_f_cooper",
    "cross_view_transformer_point_pillar_fcooper",
    # single-agent and segmentation models
    "point_pillar", "cross_view_transformer", "cvt_nofusion", "fax",
    "bevformer_wrapper", "cvt_seg", "corpbevt_seg", "bev_seg",
    "fax_fused_transformer", "view_parse_network", "view_parse_network_ms",
    "bev_swap", "voxel_net", "second", "pixor", "voxel_net_intermediate",
    "pixor_intermediate", "second_intermediate",
})


def build_model(model_cfg: dict) -> nn.Module:
    """The model of a hypes ``model`` block (``core_method``, ``args``)."""
    name = model_cfg["core_method"].lower()
    args = model_cfg["args"]
    # reference model names carry the camera branch as a prefix
    if name.startswith(("fax_", "bevformer_")) and "camera" in args:
        enc = name.split("_", 1)[0]
        args = dict(args, camera=dict(args["camera"]))
        args["camera"].setdefault("encoder", enc)
    if name in HETERO_NAMES:
        return HMViT(args)
    if name in ZOO_NAMES:
        raise NotImplementedError(
            f"model core_method {name!r} is not ported yet (the port builds "
            f"{sorted(HETERO_NAMES)}): ROADMAP.md Queue 1 item 5")
    raise ValueError(f"unknown model core_method {name!r}")
