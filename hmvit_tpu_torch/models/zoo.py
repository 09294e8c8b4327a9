"""Model registry: a model from its hypes ``model`` block (port of
``hmvit_tpu/models/zoo.py::build_model``), under the JAX registry's
names:

* the hetero (camera + lidar) assembly, :class:`HMViT` with H3GAT
  fusion (:data:`HETERO_NAMES`), or with another fusion of the zoo
  (``fusion_override``, the names of :data:`_MIXED_FUSIONS`);
* the single-agent detectors: ``point_pillar``
  (:class:`PointPillarDetector`), the camera ones
  (:class:`CameraDetector`: ``cross_view_transformer``,
  ``cvt_nofusion``, ``fax``, ``bevformer_wrapper``) and the lidar zoo
  (``voxel_net``, ``second``, ``pixor`` through
  :class:`_SingleAgentLidar`);
* the camera BEV segmentation (:class:`CameraSegmentor`: ``cvt_seg``,
  ``corpbevt_seg``, ``bev_seg``, ``fax_fused_transformer``,
  ``view_parse_network[_ms]``, ``bev_swap``);
* the intermediate-fusion detector :class:`CooperativeDetector` on one
  modality: a lidar encoder (PointPillars, or with ``lidar_encoder`` one
  of the lidar zoo's; :data:`_LIDAR_FUSIONS`, with the per-stage fusion
  of ``point_pillar_intermediate``, and ``second_intermediate``) or a
  camera encoder (:data:`_CAMERA_FUSIONS`, :data:`_VPN_FUSIONS`), for
  detection or, with ``task: seg``, segmentation;
* the cooperative VoxelNet and PIXOR (``voxel_net_intermediate``,
  ``pixor_intermediate``).

A name that starts with ``fax_`` or ``bevformer_`` names the camera
encoder, as in JAX; ``bevformer_wrapper`` with ``encoder: bevformer_ref``
is the reference's standalone detector (:class:`RefBEVFormerDetector`).
Every name of the JAX registry builds (:data:`UNPORTED` is empty); an
unknown name raises ``ValueError``, as in JAX.
"""
from __future__ import annotations

import torch
from torch import nn

from .bevformer_ref import RefBEVFormerDetector
from .fusion import make_fusion
from .hmvit import HMViT, make_camera_encoder
from .layers import DetectionHead, DownsampleConv, NaiveDecoder
from .lidar_zoo import SecondDetector, VoxelNetDetector, VoxelNetIntermediate
from .pillar_encoder import AttBEVBackbone, PillarFeatureNet, \
    PointPillarEncoder
from .pixor import PIXORDetector, PixorIntermediate
from .point_pillar import PointPillarDetector
from .seg_head import BevSegHead

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

# camera BEV segmentation: model name -> the default camera encoder
SEGMENTOR_ENCODERS = {
    "cvt_seg": None, "corpbevt_seg": None, "bev_seg": None,
    "fax_fused_transformer": "fax", "view_parse_network": "vpn",
    "view_parse_network_ms": "vpn_ms", "bev_swap": "bev_swap",
}
# the lidar zoo's encoders by ``lidar_encoder`` / single-agent name
LIDAR_ZOO = {"voxel_net": VoxelNetDetector, "second": SecondDetector,
             "pixor": PIXORDetector}
LIDAR_ZOO_COOPERATIVE = frozenset({"voxel_net_intermediate",
                                   "pixor_intermediate",
                                   "second_intermediate"})
# the names that raise, with what is missing: none left
UNPORTED: dict = {}
# every name the port builds
BUILT_NAMES = frozenset(HETERO_NAMES | set(_LIDAR_FUSIONS)
                        | set(_CAMERA_FUSIONS) | set(_VPN_FUSIONS)
                        | set(_MIXED_FUSIONS) | {"point_pillar"}
                        | CAMERA_DETECTOR_NAMES | set(SEGMENTOR_ENCODERS)
                        | set(LIDAR_ZOO) | LIDAR_ZOO_COOPERATIVE)
# the JAX registry's names other than the hetero ones
ZOO_NAMES = frozenset((BUILT_NAMES - HETERO_NAMES) | set(UNPORTED))


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


class CameraSegmentor(nn.Module):
    """Single-agent camera BEV segmentation: the camera encoder on every
    slot, the ego's BEV through :class:`BevSegHead` (``target``:
    dynamic, static or both); the outputs NHWC.  A new model is in eval
    mode."""

    def __init__(self, config: dict):
        super().__init__()
        self.config = config
        self.camera_encoder = make_camera_encoder(config["camera"])
        self.BevSegHead_0 = BevSegHead(camera_channels(config["camera"]),
                                       config.get("target", "dynamic"))
        self.eval()

    def forward(self, batch: dict) -> dict:
        b, l = batch["camera"].shape[:2]
        bev = self.camera_encoder(*(_flat(batch, k, b, l) for k in
                                    ("camera", "intrinsics", "extrinsics")))
        return self.BevSegHead_0(bev.reshape(b, l, *bev.shape[1:])[:, 0])


class _SingleAgentLidar(nn.Module):
    """A single-agent lidar detector of the zoo driven by the tools'
    batch: its ego slot's cloud.  A new model is in eval mode."""

    def __init__(self, detector_cls: type, lidar_cfg: dict):
        super().__init__()
        self.detector_name = f"{detector_cls.__name__}_0"
        self.add_module(self.detector_name, detector_cls(lidar_cfg))
        self.eval()

    def forward(self, batch: dict) -> dict:
        return getattr(self, self.detector_name)(
            batch["points"][:, 0], batch["points_mask"][:, 0])


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
    slot (lidar: PointPillars, or ``lidar_encoder`` ``voxel_net`` /
    ``second`` / ``pixor``, each returning its BEV features), a fusion
    of the zoo (``make_fusion``, with the config's ``<fusion>_fusion``
    block), the decoder (when configured) and the anchor heads, or with
    ``task: seg`` :class:`BevSegHead` (NHWC outputs).  ``att_bev``
    projects every agent's points into the ego frame and fuses inside
    the BEV backbone (:class:`AttBEVBackbone`) instead, always with the
    anchor heads, as in JAX.  A new model is in eval mode."""

    def __init__(self, config: dict, modality: str, fusion_name: str):
        super().__init__()
        cfg = config
        self.config, self.modality = cfg, modality
        self.att_bev = fusion_name == "att_bev"
        self.encoder_name = None
        if modality == "lidar":
            kind = cfg.get("lidar_encoder", "point_pillar")
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
                encoder = (PointPillarEncoder(lcfg) if kind == "point_pillar"
                           else LIDAR_ZOO[kind](lcfg, return_features=True))
                self.encoder_name = f"{type(encoder).__name__}_0"
                self.add_module(self.encoder_name, encoder)
                c = encoder.out_channels
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
        self.seg = cfg.get("task") == "seg" and not self.att_bev
        if self.seg:
            self.BevSegHead_0 = BevSegHead(c, cfg.get("target", "dynamic"))
        else:
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
            x = getattr(self, self.encoder_name)(points, pmask)
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
        if self.seg:
            return self.BevSegHead_0(fused)
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
            args = dict(args, camera=camera)
            if camera["encoder"] == "bevformer_ref":
                # the checkpoint-portable twin: trunk, decoder and heads
                return RefBEVFormerDetector(args)
        return CameraDetector(args)
    if name in SEGMENTOR_ENCODERS:
        encoder = SEGMENTOR_ENCODERS[name]
        if encoder is not None:
            args = dict(args, camera=dict(args.get("camera", {})))
            args["camera"].setdefault("encoder", encoder)
        return CameraSegmentor(args)
    if name in _VPN_FUSIONS:
        camera = dict(args.get("camera", {}))
        camera.setdefault("encoder", "vpn")
        return CooperativeDetector(dict(args, camera=camera), "camera",
                                   _VPN_FUSIONS[name])
    if name in _LIDAR_FUSIONS:
        return CooperativeDetector(args, "lidar", _LIDAR_FUSIONS[name])
    if name in _CAMERA_FUSIONS:
        return CooperativeDetector(args, "camera", _CAMERA_FUSIONS[name])
    if name in LIDAR_ZOO:
        return _SingleAgentLidar(LIDAR_ZOO[name], args.get("lidar", args))
    if name == "voxel_net_intermediate":
        return VoxelNetIntermediate(args.get("lidar", args))
    if name == "pixor_intermediate":
        return PixorIntermediate(args.get("lidar", args))
    if name == "second_intermediate":
        return CooperativeDetector(dict(args, lidar_encoder="second"),
                                   "lidar", "att")
    raise ValueError(f"unknown model core_method {name!r}")
