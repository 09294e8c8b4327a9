"""HM-ViT flagship: hetero-modal multi-agent cooperative detector (port
of ``hmvit_tpu/models/hmvit.py``; camera branch: any camera encoder of
:func:`make_camera_encoder`, the cross-view transformer by default;
fusion: H3GAT, or the fusion of the zoo ``fusion_override`` names).
mode convention: 0 = camera, 1 = lidar.  ``train()`` is the JAX model's
``train=True``: batch statistics, dropout, and remat over the stages
``cfg["remat"]`` names.
"""
from __future__ import annotations

import torch
from torch import nn

from .bev_swap import BEVSwapEncoder
from .bevformer import BEVFormerEncoder
from .bevformer_ref import RefBEVFormerCameraEncoder
from .cvt import CrossViewTransformer
from .cvt_ref import CVTRefCameraEncoder
from .fax import FAXCameraEncoder
from .fax_ref import FAXRefCameraEncoder
from .fusion import make_fusion
from .. import tracing
from ..nn import DTYPES, remat
from .hetero_fusion import HeteroFusion
from .layers import DetectionHead, NaiveCompressor, NaiveDecoder
from .pillar_encoder import PointPillarEncoder
from .vpn import ViewParseNetwork


# the camera encoders the port builds, by the config's ``encoder`` key
# (the ``*_ref`` ones are the reference-faithful twins that a converted
# reference checkpoint fills)
CAMERA_ENCODERS = {"cvt": CrossViewTransformer, "fax": FAXCameraEncoder,
                   "bevformer": BEVFormerEncoder, "vpn": ViewParseNetwork,
                   "vpn_ms": ViewParseNetwork, "bev_swap": BEVSwapEncoder,
                   "fax_ref": FAXRefCameraEncoder,
                   "cvt_ref": CVTRefCameraEncoder,
                   "bevformer_ref": RefBEVFormerCameraEncoder}
# the fusion overrides that take the batch's prior_encoding
PRIOR_FUSIONS = ("v2xvit", "v2xt")


def make_camera_encoder(cfg: dict) -> nn.Module:
    """The camera -> BEV encoder ``cfg["encoder"]`` names (a key of
    :data:`CAMERA_ENCODERS`; ``cvt`` by default)."""
    kind = cfg.get("encoder", "cvt")
    if kind not in CAMERA_ENCODERS:
        raise ValueError(f"unknown camera encoder {kind!r}")
    return CAMERA_ENCODERS[kind](cfg)


class HeteroDecoder(nn.Module):
    """Per-modality decoder + heads, selected by the ego's modality."""

    def __init__(self, cin: int, num_layer: int, num_ch_dec,
                 anchor_number: int, use_upsample: bool = False,
                 bn_eps: float = 1e-3):
        super().__init__()
        for name in ("camera", "lidar"):
            self.add_module(f"{name}_decoder", NaiveDecoder(
                cin, num_layer, num_ch_dec, use_upsample=use_upsample,
                bn_eps=bn_eps))
            self.add_module(f"{name}_head",
                            DetectionHead(num_ch_dec[0], anchor_number))

    def _branch(self, name, x):
        return getattr(self, f"{name}_head")(
            getattr(self, f"{name}_decoder")(x))

    def forward(self, x, ego_mode, static_ego_modality: int | None = None):
        """x (B, H, W, C); ego_mode (B,).  A static ego modality (serving
        hint) runs only that branch, in eval mode (in train mode both
        branches run, as in the JAX model, and each branch's BatchNorm
        sees every row)."""
        if static_ego_modality == 0 and not self.training:
            return self._branch("camera", x)
        if static_ego_modality == 1 and not self.training:
            return self._branch("lidar", x)
        cam_psm, cam_rm = self._branch("camera", x)
        lid_psm, lid_rm = self._branch("lidar", x)
        is_lidar = (ego_mode == 1)[:, None, None, None]
        return (torch.where(is_lidar, lid_psm, cam_psm),
                torch.where(is_lidar, lid_rm, cam_rm))


def _capturing(t) -> bool:
    """Whether a CUDA-graph capture is running on ``t``'s stream."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


# the stages ``remat: true`` checkpoints
REMAT_STAGES = ("camera", "lidar", "fusion")


def remat_stages(remat) -> frozenset:
    """The stages a config's ``remat`` checkpoints in train mode: all
    three for True, the listed ones for a list, none when unset."""
    if not remat:
        return frozenset()
    return frozenset(REMAT_STAGES if remat is True else remat)

_SLICED = ("mode", "agent_mask", "points", "points_mask", "camera",
           "intrinsics", "extrinsics", "prior_encoding")


class HMViT(nn.Module):
    """Hetero-modal cooperative detector: lidar PointPillars + a camera
    encoder (:func:`make_camera_encoder`), the bandwidth compressor when
    ``compression`` is non-zero, H3GAT fusion (or ``fusion_override``'s
    fusion of ``models/fusion``), per-modality decoder.  A new model is
    in eval mode."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        self.config = cfg
        self.lidar_encoder = PointPillarEncoder(cfg["lidar"])
        self.camera_encoder = make_camera_encoder(cfg["camera"])
        # the agent maps' channels (both encoders give the same)
        c = self.lidar_encoder.out_channels
        if cfg.get("compression", 0):
            self.NaiveCompressor_0 = NaiveCompressor(c, cfg["compression"])
        self.fusion_override = cfg.get("fusion_override")
        if self.fusion_override:
            # built as the JAX model builds it: no fusion arguments, the
            # agents' context for V2X-ViT (the port's batches carry it)
            fusion = make_fusion(
                self.fusion_override, c, cfg.get("spatial_transform", {}),
                prior_encoding=self.fusion_override in PRIOR_FUSIONS)
            # flax names an unnamed module by its class
            self.fusion_name = f"{type(fusion).__name__}_0"
            self.add_module(self.fusion_name, fusion)
        else:
            self.fusion = HeteroFusion(cfg["hetero_fusion"])
        dec = cfg["hetero_decoder"]
        self.HeteroDecoder_0 = HeteroDecoder(
            dec["input_dim"], dec["num_layer"], tuple(dec["num_ch_dec"]),
            dec["anchor_number"], bn_eps=dec.get("bn_eps", 1e-3))
        self.eval()

    def forward(self, batch: dict, camera_bucket: int | None = None,
                active_agents: int | None = None,
                static_ego_modality: int | None = None,
                static_modes: tuple | None = None, sp=None):
        """Serving shape buckets, as in the JAX model:

        - ``active_agents`` slices the agent axis to the first A slots;
        - ``camera_bucket`` runs the camera encoder on exactly that many
          slots (camera-first stable order) and the lidar encoder on the
          rest; it must equal the true camera count of the whole batch,
          which ``debug_checks: true`` in the config enforces with one
          read of ``mode`` (``static_modes``, when given, is held against
          the same read; under a CUDA-graph capture the check raises);
          without it the branch reads nothing back;
        - ``static_modes`` is the fleet's per-agent modality layout (after
          slicing) and must equal the batch's ``mode`` row;
        - ``static_ego_modality`` runs only the ego's decoder branch.
        None of them: both encoders on every slot, selected by mode (the
        training trace: each encoder's BatchNorm then sees every slot,
        the other modality's dummy rows included, as in the JAX model).

        Spatial partitioning (``parallel.make_spatial_eval``): ``sp=(mesh,
        axis)`` splits the per-agent maps' rows over ``axis`` where they
        meet the fusion (``parallel.row_shard``: ceil(H / shards) rows a
        shard, an uneven split padded with zero rows); the H3GAT fusion
        runs on the rows (``models/hetero_fusion.py``), and the fused ego
        map is gathered, cropped to H, before the decoder, which runs
        whole.
        A ``fusion_override`` fusion runs on the whole map.
        With the tracer on (:mod:`hmvit_tpu_torch.tracing`), the lidar,
        camera, fusion and decoder stages are marked.
        Returns {"psm": (B, A, H, W), "rm": (B, 7A, H, W)}."""
        if active_agents is not None:
            batch = {k: (v[:, :active_agents] if k in _SLICED else v)
                     for k, v in batch.items()}
            batch["pairwise_t_matrix"] = batch["pairwise_t_matrix"][
                :, :active_agents, :active_agents]
        mode = batch["mode"].long()
        agent_mask = batch["agent_mask"].to(torch.float32)
        pairwise = batch["pairwise_t_matrix"]
        b, l = mode.shape

        def flat(key):
            v = batch[key]
            return v.reshape(b * l, *v.shape[2:])

        points, pmask = flat("points"), flat("points_mask")
        cams, intr, extr = flat("camera"), flat("intrinsics"), \
            flat("extrinsics")
        stages = (remat_stages(self.config.get("remat")) if self.training
                  else frozenset())

        def stage(name, module, *args, **kwargs):
            with tracing.mark(name, mode):
                if name in stages:
                    return remat(module, *args, **kwargs)
                return module(*args, **kwargs)

        def run_lidar(p, m):
            return stage("lidar", self.lidar_encoder, p, m)

        def run_camera(c, i, e):
            return stage("camera", self.camera_encoder, c, i, e)

        if camera_bucket is None:
            lidar_bev = run_lidar(points, pmask)
            cam_bev = run_camera(cams, intr, extr)
            is_lidar = (mode.reshape(-1) == 1)[:, None, None, None]
            x = torch.where(is_lidar, lidar_bev, cam_bev)
        elif camera_bucket == 0:
            x = run_lidar(points, pmask)
        elif camera_bucket >= b * l:
            # every slot of the batch is a camera (the JAX model compares
            # with l, the slots of ONE row, which at batch > 1 sends the
            # lidar agents of a mixed batch through the camera encoder)
            x = run_camera(cams, intr, extr)
        else:
            nc = camera_bucket
            order = torch.argsort(mode.reshape(-1), stable=True)
            cam_idx, lid_idx = order[:nc], order[nc:]
            if self.config.get("debug_checks", False):
                # the one host read of the branch, under debug_checks only
                if _capturing(mode):
                    raise RuntimeError(
                        "debug_checks: the camera_bucket / static_modes check "
                        "reads the batch's mode back to the host, which a "
                        "CUDA-graph capture cannot do; capture a model "
                        "without debug_checks")
                rows = mode.cpu().tolist()
                if static_modes is not None and any(
                        row != [int(m) for m in static_modes]
                        for row in rows):
                    raise ValueError(
                        f"static_modes={tuple(static_modes)} differs from "
                        f"the batch's mode {rows}")
                cameras = sum(row.count(0) for row in rows)
                if cameras < nc:
                    raise ValueError(
                        f"camera_bucket={nc} exceeds the batch's true camera "
                        f"count {cameras}: the first {nc} mode-sorted slots "
                        "include lidar agents, which would silently receive "
                        "camera-encoded features")
            cam_bev = run_camera(cams[cam_idx], intr[cam_idx], extr[cam_idx])
            lidar_bev = run_lidar(points[lid_idx], pmask[lid_idx])
            x = torch.zeros((b * l, *cam_bev.shape[1:]),
                            dtype=torch.promote_types(cam_bev.dtype,
                                                      lidar_bev.dtype),
                            device=cam_bev.device)
            x[cam_idx] = cam_bev.to(x.dtype)
            x[lid_idx] = lidar_bev.to(x.dtype)

        if self.config.get("compression", 0):
            x = self.NaiveCompressor_0(x)
        h, w, c = x.shape[1:]
        x = x.reshape(b, l, h, w, c)
        fusion_sp = (*sp, h) if sp is not None and not self.fusion_override \
            else None
        if fusion_sp is not None:
            from ..parallel.mesh import row_shard

            x = row_shard(*sp)(x)
        x = x * agent_mask[:, :, None, None, None]
        if self.fusion_override:
            # never under remat, as in the JAX model
            kwargs = {}
            if self.fusion_override in PRIOR_FUSIONS:
                if "prior_encoding" not in batch:
                    raise ValueError(
                        f"fusion_override {self.fusion_override!r} takes the "
                        f"batch's prior_encoding, which it lacks")
                kwargs["prior_encoding"] = batch["prior_encoding"]
            with tracing.mark("fusion", mode):
                ego = getattr(self, self.fusion_name)(x, mode, pairwise,
                                                      agent_mask, **kwargs)
        else:
            ego = stage("fusion", self.fusion, x, mode, pairwise, agent_mask,
                        static_modes=static_modes, sp=fusion_sp)
        if fusion_sp is not None:
            # the decoder runs on the whole fused map
            from ..parallel.collectives import gather_rows
            from ..parallel.mesh import axis_group

            ego = gather_rows(ego, 1, axis_group(*sp))[:, :h]
        dec = self.config["hetero_decoder"]
        if dec.get("compute_dtype"):
            ego = ego.to(DTYPES[dec["compute_dtype"]])
        with tracing.mark("decoder", mode):
            psm, rm = self.HeteroDecoder_0(ego, mode[:, 0],
                                           static_ego_modality)
        return {"psm": psm.permute(0, 3, 1, 2), "rm": rm.permute(0, 3, 1, 2)}
