"""Model registry: a model from its hypes ``model`` block (port of
``hmvit_tpu/models/zoo.py::build_model``), under the JAX registry's
names:

* the hetero (camera + lidar) assembly, :class:`HMViT` with H3GAT
  fusion (:data:`HETERO_NAMES`), or with another fusion of the zoo
  (``fusion_override``, the names of :data:`_MIXED_FUSIONS`);
* the single-agent detectors: ``point_pillar``
  (:class:`PointPillarDetector`) and the camera ones
  (:class:`CameraDetector`: ``cross_view_transformer``,
  ``cvt_nofusion``, ``fax``, ``bevformer_wrapper``);
* the intermediate-fusion detector :class:`CooperativeDetector` on one
  modality: lidar PointPillars (:data:`_LIDAR_FUSIONS`, with the
  per-stage fusion of ``point_pillar_intermediate``) or a camera encoder
  (:data:`_CAMERA_FUSIONS`, :data:`_VPN_FUSIONS`), for detection.

A name that starts with ``fax_`` or ``bevformer_`` names the camera
encoder, as in JAX.  What is not ported yet raises
``NotImplementedError`` naming its ROADMAP.md item (:data:`UNPORTED`,
and the segmentation task, the reference twins and the lidar zoo's
encoders under a built name); an unknown name raises ``ValueError``, as
in JAX.
"""
from __future__ import annotations

import torch
from torch import nn

from .fusion import make_fusion
from .hmvit import HMViT, make_camera_encoder
from .layers import DetectionHead, DownsampleConv, NaiveDecoder
from .pillar_encoder import AttBEVBackbone, PillarFeatureNet, \
    PointPillarEncoder
from .point_pillar import PointPillarDetector

HETERO_NAMES = frozenset({
    "hmvit", "hetero_hmvit", "bevformer_point_pillar_hetero",
    "fax_point_pillar_hetero",
})
# the JAX registry's tables: model name -> fusion name
_LIDAR_FUSIONS = {
    "point_pillar_fcooper": "fcooper",
    "point_pillar_opv2v": "att",
    # per-stage agent fusion inside the BEV backbone
    "point_pillar_intermediate": "att_bev",
    "point_pillar_v2vnet": "v2vnet",
    "point_pillar_disconet": "disconet",
    "point_pillar_swap": "swap",
    "point_pillar_cobevt": "swap",
    "point_pillar_transformer": "v2xvit",
    "point_pillar_v2xt": "v2xvit",
}
_CAMERA_FUSIONS = {
    "cvt_fcooper": "fcooper",
    "cvt_att_fuse": "att",
    "cvt_v2vnet": "v2vnet",
    "cvt_disconet": "disconet",
    "corpbevt": "swap",
    "cvt_swap_fuse": "swap",
    "cross_view_transformer_fcooper": "fcooper",
    "cross_view_transformer_att_fuse": "att",
    "cross_view_transformer_v2vnet": "v2vnet",
    "cross_view_transformer_disconet": "disconet",
    "cross_view_transformer_swap_fuse": "swap",
    "cvt_v2xt": "v2xvit",
    "v2xt_camera": "v2xvit",
}
# the VPN camera encoder under a cooperative fusion
_VPN_FUSIONS = {
    "view_parse_network_att_fuse": "att",
    "view_parse_network_fcooper": "fcooper",
    "view_parse_network_swap_fuse": "swap",
    "view_parse_network_v2vnet": "v2vnet",
}
# HMViT with another fusion than H3GAT
_MIXED_FUSIONS = {
    "fax_point_pillar_fcooper": "fcooper",
    "fax_point_pillar_att_fuse": "att",
    "fax_point_pillar_v2vnet": "v2vnet",
    "fax_point_pillar_disconet": "disconet",
    "fax_point_pillar_fax": "swap",
    "bevformer_point_pillar_fax": "swap",
    "fax_point_pillar_v2xt": "v2xvit",
    "bevformer_point_pillar_v2xt": "v2xvit",
    "bevformer_point_pillar_att_fuse": "att",
    "bevformer_point_pillar_disconet": "disconet",
    "bevformer_point_pillar_v2vnet": "v2vnet",
    # the CVT camera branch
    "point_pillar_cross_view_transformer_f_cooper": "fcooper",
    "cross_view_transformer_point_pillar_fcooper": "fcooper",
}
CAMERA_DETECTOR_NAMES = frozenset({"cross_view_transformer", "cvt_nofusion",
                                   "fax", "bevformer_wrapper"})

_SEGMENTATION = ("the segmentation assemblies (CameraSegmentor, the BEV "
                 "segmentation head and its post-processing)")
_LIDAR_ZOO = "the lidar zoo (VoxelNet, SECOND, PIXOR)"
# the names that raise, with what is missing
UNPORTED = {
    **dict.fromkeys(("cvt_seg", "corpbevt_seg", "bev_seg",
                     "fax_fused_transformer", "view_parse_network",
                     "view_parse_network_ms", "bev_swap"), _SEGMENTATION),
    **dict.fromkeys(("voxel_net", "second", "pixor", "voxel_net_intermediate",
                     "pixor_intermediate", "second_intermediate"),
                    _LIDAR_ZOO),
}
# every name the port builds
BUILT_NAMES = frozenset(HETERO_NAMES | set(_LIDAR_FUSIONS)
                        | set(_CAMERA_FUSIONS) | set(_VPN_FUSIONS)
                        | set(_MIXED_FUSIONS) | {"point_pillar"}
                        | CAMERA_DETECTOR_NAMES)
# the JAX registry's names other than the hetero ones
ZOO_NAMES = frozenset((BUILT_NAMES - HETERO_NAMES) | set(UNPORTED))


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what}: not ported yet, ROADMAP.md Queue 1 "
                               f"item 5")


def camera_channels(camera_cfg: dict) -> int:
    """The channels of a camera encoder's BEV (every encoder's
    ``out_dim``)."""
    return camera_cfg.get("out_dim", 256)


def _flat(batch: dict, key: str, b: int, l: int):
    v = batch[key]
    return v.reshape(b * l, *v.shape[2:])


def _heads(head, x) -> dict:
    psm, rm = head(x)
    return {"psm": psm.permute(0, 3, 1, 2), "rm": rm.permute(0, 3, 1, 2)}


class CameraDetector(nn.Module):
    """Single-agent camera detector: the camera encoder on every slot,
    the ego's BEV through the anchor heads.  A new model is in eval
    mode."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = config
        self.camera_encoder = make_camera_encoder(config["camera"])
        self.DetectionHead_0 = DetectionHead(
            camera_channels(config["camera"]), config["anchor_number"])
        self.eval()

    def forward(self, batch: dict) -> dict:
        b, l = batch["camera"].shape[:2]
        bev = self.camera_encoder(*(_flat(batch, k, b, l) for k in
                                    ("camera", "intrinsics", "extrinsics")))
        return _heads(self.DetectionHead_0,
                      bev.reshape(b, l, *bev.shape[1:])[:, 0])


def project_points_to_ego(points, transform):
    """(B, L, P, >= 3) points in each agent's frame -> the ego frame by
    the agents' (B, L, 4, 4) transforms; the features past xyz kept.
    Written out elementwise: exact float32 (never TF32)."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rows = [(transform[:, :, i, 0, None] * x + transform[:, :, i, 1, None] * y
             + transform[:, :, i, 2, None] * z + transform[:, :, i, 3, None])
            for i in range(3)]
    return torch.cat([torch.stack(rows, dim=-1), points[..., 3:]], dim=-1)


class CooperativeDetector(nn.Module):
    """Intermediate-fusion detector: one modality's encoder on every agent
    slot, a fusion of the zoo (``make_fusion``, with the config's
    ``<fusion>_fusion`` block), the decoder (when configured) and the
    anchor heads.  ``att_bev`` projects every agent's points into the
    ego frame and fuses inside the BEV backbone (:class:`AttBEVBackbone`)
    instead.  A new model is in eval mode."""

    def __init__(self, config: dict, modality: str, fusion_name: str):
        super().__init__()
        cfg = config
        if cfg.get("task") == "seg":
            raise not_ported(f"task: seg ({_SEGMENTATION})")
        self.config, self.modality = cfg, modality
        self.att_bev = fusion_name == "att_bev"
        if modality == "lidar":
            kind = cfg.get("lidar_encoder", "point_pillar")
            if kind != "point_pillar":
                raise not_ported(f"lidar_encoder {kind!r}: {_LIDAR_ZOO}")
            lcfg = cfg["lidar"]
            if self.att_bev:
                vfe = lcfg["pillar_vfe"]
                self.PillarFeatureNet_0 = PillarFeatureNet(
                    num_filters=vfe["num_filters"],
                    voxel_size=lcfg["voxel_size"],
                    pc_range=lcfg["lidar_range"],
                    grid_size=lcfg["point_pillar_scatter"]["grid_size"][:2])
                bb = lcfg["base_bev_backbone"]
                self.AttBEVBackbone_0 = AttBEVBackbone(
                    vfe["num_filters"][-1], bb["layer_nums"],
                    bb["layer_strides"], bb["num_filters"],
                    bb["upsample_strides"], bb["num_upsample_filter"])
                c = self.AttBEVBackbone_0.out_channels
                self.DownsampleConv_0 = None
                if "shrink_header" in lcfg:
                    sh = lcfg["shrink_header"]
                    self.DownsampleConv_0 = DownsampleConv(
                        c, sh["kernal_size"], sh["dim"], sh["stride"])
                    c = sh["dim"][-1]
            else:
                self.PointPillarEncoder_0 = PointPillarEncoder(lcfg)
                c = self.PointPillarEncoder_0.out_channels
        else:
            self.camera_encoder = make_camera_encoder(cfg["camera"])
            c = camera_channels(cfg["camera"])
        self.fusion_name = None
        if not self.att_bev:
            fusion = make_fusion(fusion_name, c,
                                 cfg.get("spatial_transform", {}),
                                 cfg.get(f"{fusion_name}_fusion"))
            # flax names an unnamed module by its class
            self.fusion_name = f"{type(fusion).__name__}_0"
            self.add_module(self.fusion_name, fusion)
        self.NaiveDecoder_0 = None
        dec = cfg.get("decoder")
        if dec:
            self.NaiveDecoder_0 = NaiveDecoder(c, dec["num_layer"],
                                               dec["num_ch_dec"],
                                               use_upsample=False)
            c = dec["num_ch_dec"][0]
        self.DetectionHead_0 = DetectionHead(c, cfg["anchor_number"])
        self.eval()

    def forward(self, batch: dict) -> dict:
        mode = batch["mode"].long()
        agent_mask = batch["agent_mask"].to(torch.float32)
        b, l = mode.shape
        if self.modality == "lidar":
            points = batch["points"]
            if self.att_bev:
                points = project_points_to_ego(
                    points, batch["transformation_matrix"])
            points = points.reshape(b * l, *points.shape[2:])
            pmask = batch["points_mask"].reshape(b * l, -1)
            if self.att_bev:
                bev = self.PillarFeatureNet_0(points, pmask)
                fused = self.AttBEVBackbone_0(
                    bev.reshape(b, l, *bev.shape[1:]), agent_mask)
                if self.DownsampleConv_0 is not None:
                    fused = self.DownsampleConv_0(fused)
                return self._decode(fused)
            x = self.PointPillarEncoder_0(points, pmask)
        else:
            x = self.camera_encoder(*(_flat(batch, k, b, l) for k in
                                      ("camera", "intrinsics",
                                       "extrinsics")))
        x = x.reshape(b, l, *x.shape[1:]) * agent_mask[:, :, None, None, None]
        fused = getattr(self, self.fusion_name)(
            x, mode, batch["pairwise_t_matrix"], agent_mask)
        return self._decode(fused)

    def _decode(self, fused) -> dict:
        if self.NaiveDecoder_0 is not None:
            fused = self.NaiveDecoder_0(fused)
        return _heads(self.DetectionHead_0, fused)


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
    if name in _MIXED_FUSIONS:
        camera = dict(args.get("camera", {}))
        if name.startswith(("point_pillar_cross_view_transformer",
                            "cross_view_transformer_point_pillar")):
            camera.setdefault("encoder", "cvt")
        args = dict(args, camera=camera) if camera else args
        return HMViT(dict(args, fusion_override=_MIXED_FUSIONS[name]))
    if name == "point_pillar":
        return PointPillarDetector(args.get("lidar", args)).eval()
    if name in CAMERA_DETECTOR_NAMES:
        if name == "bevformer_wrapper":
            camera = dict(args.get("camera", {}))
            camera.setdefault("encoder", "bevformer")
            if camera["encoder"] == "bevformer_ref":
                raise not_ported("bevformer_wrapper with the bevformer_ref "
                                 "encoder (the reference twins)")
            args = dict(args, camera=camera)
        return CameraDetector(args)
    if name in _VPN_FUSIONS:
        camera = dict(args.get("camera", {}))
        camera.setdefault("encoder", "vpn")
        return CooperativeDetector(dict(args, camera=camera), "camera",
                                   _VPN_FUSIONS[name])
    if name in _LIDAR_FUSIONS:
        return CooperativeDetector(args, "lidar", _LIDAR_FUSIONS[name])
    if name in _CAMERA_FUSIONS:
        return CooperativeDetector(args, "camera", _CAMERA_FUSIONS[name])
    if name in UNPORTED:
        raise not_ported(f"model core_method {name!r}: {UNPORTED[name]}")
    raise ValueError(f"unknown model core_method {name!r}")
