"""Reference-faithful BEVFormer camera trunk (port of
``hmvit_tpu/models/bevformer_ref.py``).

The structural twin of the reference's mmdet3d BEVFormer run under
``only_bev``: ResNet-50 C5 -> a single-level FPN -> 3 post-norm encoder
layers of TemporalSelfAttention + SpatialCrossAttention + FFN over a
128^2 learned BEV query grid, parameter for parameter, so that the
camera subtree of a reference ``net_epoch%d.pth`` ports
(``tools/convert_checkpoint.py --core_method
bevformer_point_pillar_hetero``).  The planar-lift encoder
(:mod:`hmvit_tpu_torch.models.bevformer`) stays the serving default;
this one is the camera config's ``encoder: bevformer_ref``.

The reference's quirks, which the JAX twin transcribes, are kept as
they are:

- post-norm order (self_attn, norm, cross_attn, norm, ffn, norm), the
  residuals inside each attention;
- TSA conditions its offsets and weights on ``cat([value[:bs],
  query + bev_pos])`` where ``value`` is the 2-slot queue interleaved
  over the batch: at batch > 1 ``value[:bs]`` mixes batch rows;
- SCA gates each camera's queries by batch 0's visibility while it
  normalises by each batch row's own camera count; it stays dense and
  masked (fixed shapes, no ``nonzero``), so a CUDA graph can capture it;
- the UE4 -> OpenCV flip carries the extra ``[1, 1] = -1`` entry;
- the ResNet-50 pads on PyTorch's grid (``torch_padding``) and takes
  its images in float32 (so under a bf16 cast of the weights the trunk
  computes in float32, by promotion, as the flax module does).

The deformable sampling is :func:`hmvit_tpu_torch.ops.sampling.
ms_deform_attn`: on the card the port's own CUDA kernel
(``csrc/ms_deform_attn.cu``, one pass, nothing intermediate in device
memory; XLA gathers in JAX, which has no Pallas kernel here), on the CPU
its plain twin.  The geometry is float32 and written out elementwise
(never TF32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Conv, Dense, LayerNorm, normal_, promote, uniform_
from ..ops.sampling import ms_deform_attn
from ..utils.constants import device_constant
from .fax_ref import inv, mm
from .resnet import ResNetEncoder

# the reference wrapper's UE4 -> OpenCV flip, with its [1, 1] = -1 entry
_FLIP = ((0.0, 1.0, 0.0, 0.0), (0.0, -1.0, -1.0, 0.0),
         (1.0, 0.0, 0.0, 0.0), (0.0, 0.0, 0.0, 1.0))


def lidar2img_ref(intrinsics, extrinsics):
    """(N, M, 3, 3) intrinsics + (N, M, 4, 4) camera -> agent extrinsics
    -> (N, M, 4, 4) float32 agent -> image projections."""
    cav2cam = inv(extrinsics)
    flip = device_constant(_FLIP, torch.float32, cav2cam.device)
    intr = F.pad(intrinsics.to(torch.float32), (0, 1, 0, 1))
    corner = device_constant(((0.0,) * 4,) * 3 + ((0.0, 0.0, 0.0, 1.0),),
                             torch.float32, cav2cam.device)
    return mm(intr + corner, mm(flip, cav2cam))


def linspace_f32(start: float, stop: float, num: int, device):
    """``jnp.linspace(start, stop, num)`` in float32, by its formula:
    start (1 - i / div) + stop (i / div) for i < div, then stop."""
    f32 = torch.float32
    if num == 1:
        return torch.full((1,), start, dtype=f32, device=device)
    div = num - 1
    step = torch.arange(div, dtype=f32, device=device) / div
    lo = torch.full((), start, dtype=f32, device=device)
    hi = torch.full((), stop, dtype=f32, device=device)
    return torch.cat([lo * (1 - step) + hi * step, hi[None]])


def _reference_points_3d(bev_h, bev_w, num_points_in_pillar, z_extent,
                         device):
    """Normalised 3-D pillar reference points (D, H W, 3) in [0, 1]."""
    d = num_points_in_pillar
    zs = linspace_f32(0.5, z_extent - 0.5, d, device) / z_extent
    xs = linspace_f32(0.5, bev_w - 0.5, bev_w, device) / bev_w
    ys = linspace_f32(0.5, bev_h - 0.5, bev_h, device) / bev_h
    zz = zs[:, None, None].expand(d, bev_h, bev_w)
    xx = xs[None, None, :].expand(d, bev_h, bev_w)
    yy = ys[None, :, None].expand(d, bev_h, bev_w)
    return torch.stack([xx, yy, zz], -1).reshape(d, bev_h * bev_w, 3)


def _reference_points_2d(bev_h, bev_w, device):
    """(H W, 2) normalised BEV-plane reference points (x, y)."""
    ys = linspace_f32(0.5, bev_h - 0.5, bev_h, device) / bev_h
    xs = linspace_f32(0.5, bev_w - 0.5, bev_w, device) / bev_w
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], -1)


def point_sampling(ref_3d, pc_range, l2i, img_hw):
    """Project the normalised pillar points into every camera (float32).

    ref_3d (D, Q, 3); l2i (N, M, 4, 4); img_hw (H, W).  Returns the
    reference points in the cameras (M, N, Q, D, 2), normalised by the
    image size, and the visibility mask (M, N, Q, D)."""
    ref = ref_3d.to(torch.float32)
    ref = torch.stack([
        ref[..., i] * (pc_range[i + 3] - pc_range[i]) + pc_range[i]
        for i in range(3)], -1)
    hom = torch.cat([ref, torch.ones_like(ref[..., :1])], -1)
    # (D, N, M, Q, 4): x_cam = l2i @ x_hom, written out elementwise
    cam = (l2i.to(torch.float32)[None, :, :, None]
           * hom[:, None, None, :, None, :]).sum(-1)
    eps = 1e-5
    mask = cam[..., 2:3] > eps
    uv = cam[..., 0:2] / torch.clamp(cam[..., 2:3], min=eps)
    uv = torch.stack([uv[..., 0] / img_hw[1], uv[..., 1] / img_hw[0]], -1)
    mask = (mask[..., 0]
            & (uv[..., 1] > 0.0) & (uv[..., 1] < 1.0)
            & (uv[..., 0] > 0.0) & (uv[..., 0] < 1.0))
    return uv.permute(2, 1, 3, 0, 4), mask.permute(2, 1, 3, 0)


def _deform(value, hw, loc, weights):
    """:func:`ms_deform_attn` on one level, the weights in the value's
    promoted type (``jnp.einsum`` promotes its operands), every operand
    contiguous as the kernel takes it (a reshape of a permuted tensor may
    be a strided view)."""
    dt = promote(value, weights)
    return ms_deform_attn(value.to(dt).contiguous(), [hw], loc.contiguous(),
                          weights.to(dt).contiguous())


class RefTemporalSelfAttention(nn.Module):
    """TemporalSelfAttention with one level and no history
    (prev_bev=None: the queue is [query, query])."""

    def __init__(self, dim: int, heads: int = 8, points: int = 4,
                 queue: int = 2):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.points, self.queue = points, queue
        self.value_proj = Dense(dim, dim)
        self.sampling_offsets = Dense(2 * dim, queue * heads * points * 2)
        self.attention_weights = Dense(2 * dim, queue * heads * points)
        self.output_proj = Dense(dim, dim)

    def forward(self, query, query_pos, bev_hw):
        n, q, c = query.shape
        heads, points = self.heads, self.points
        identity = query
        qp = query + query_pos
        # the batch-interleaved queue; the condition's previous part is
        # value[:n] (the reference's quirk: at n > 1 it mixes rows)
        value = torch.stack([query, query], 1).reshape(2 * n, q, c)
        dt = promote(value, qp)
        cond = torch.cat([value[:n].to(dt), qp.to(dt)], -1)
        value = self.value_proj(value).reshape(2 * n, q, heads,
                                               self.dim // heads)
        off = self.sampling_offsets(cond).reshape(n, q, heads, self.queue,
                                                  1, points, 2)
        w = self.attention_weights(cond).reshape(n, q, heads, self.queue,
                                                 points)
        w = torch.softmax(w, -1)
        # (n, q, heads, queue, ...) -> (n queue interleaved, q, heads, ...)
        off = off.permute(0, 3, 1, 2, 4, 5, 6).reshape(2 * n, q, heads, 1,
                                                       points, 2)
        w = w.permute(0, 3, 1, 2, 4).reshape(2 * n, q, heads, 1, points)
        ref = _reference_points_2d(*bev_hw, query.device)
        norm = device_constant((float(bev_hw[1]), float(bev_hw[0])),
                               torch.float32, query.device)
        loc = ref[None, :, None, None, None, :] + off / norm
        out = _deform(value, bev_hw, loc, w)
        # the queue's mean: rows (2 b, 2 b + 1) -> batch row b
        out = out.reshape(n, 2, q, c).mean(1)
        return self.output_proj(out) + identity


class RefSpatialCrossAttention(nn.Module):
    """SpatialCrossAttention + MSDeformableAttention3D with one level,
    dense and masked: every query samples in every camera, the
    contributions gated by batch 0's visibility and normalised by each
    batch row's own visible-camera count."""

    def __init__(self, dim: int, heads: int = 8, points: int = 8):
        super().__init__()
        self.dim, self.heads, self.points = dim, heads, points
        self.value_proj = Dense(dim, dim)
        self.sampling_offsets = Dense(dim, heads * points * 2)
        self.attention_weights = Dense(dim, heads * points)
        self.output_proj = Dense(dim, dim)

    def forward(self, query, cam_feats, ref_cam, bev_mask, feat_hw):
        """query (N, Q, C); cam_feats (N, M, l, C) (embeddings added);
        ref_cam (M, N, Q, D, 2); bev_mask (M, N, Q, D)."""
        n, q, c = query.shape
        m = cam_feats.shape[1]
        d = ref_cam.shape[3]
        heads, points = self.heads, self.points
        p_per = points // d
        value = self.value_proj(cam_feats).reshape(n * m, -1, heads,
                                                   self.dim // heads)
        off = self.sampling_offsets(query)
        w = torch.softmax(self.attention_weights(query).reshape(
            n, q, heads, points), -1)
        norm = device_constant((float(feat_hw[1]), float(feat_hw[0])),
                               torch.float32, query.device)
        off = off.reshape(n, q, heads, points, 2) / norm
        # flat point o = p D + z: its reference anchor is z = o % D
        off = off.reshape(n, 1, q, heads, p_per, d, 2)
        ref = ref_cam.permute(1, 0, 2, 3, 4)  # (N, M, Q, D, 2)
        loc = ref[:, :, :, None, None, :, :] + off
        loc = loc.reshape(n * m, q, heads, 1, points, 2)
        wm = w[:, None].expand(n, m, q, heads, points).reshape(
            n * m, q, heads, 1, points)
        out = _deform(value, feat_hw, loc, wm).reshape(n, m, q, c)
        # gated by batch 0's visibility (the reference's rebatch indexes),
        # normalised by each batch row's own visible-camera count
        gate0 = bev_mask[:, 0].any(-1)  # (M, Q)
        out = out * gate0[None, :, :, None].to(out.dtype)
        slots = out.sum(1)
        count = bev_mask.any(-1).to(torch.float32).sum(0).reshape(n, q)
        slots = slots / torch.clamp(count, min=1.0)[..., None]
        return self.output_proj(slots) + query


class RefBEVFormerLayer(nn.Module):
    """One post-norm encoder layer: TSA, norm, SCA, norm, FFN, norm."""

    def __init__(self, dim: int, ffn_dim: int, tsa_heads: int = 8,
                 tsa_points: int = 4, sca_heads: int = 8,
                 sca_points: int = 8):
        super().__init__()
        self.tsa = RefTemporalSelfAttention(dim, tsa_heads, tsa_points)
        self.norm0 = LayerNorm(dim)
        self.sca = RefSpatialCrossAttention(dim, sca_heads, sca_points)
        self.norm1 = LayerNorm(dim)
        self.ffn_fc1 = Dense(dim, ffn_dim)
        self.ffn_fc2 = Dense(ffn_dim, dim)
        self.norm2 = LayerNorm(dim)

    def forward(self, x, bev_pos, cam_feats, ref_cam, bev_mask, bev_hw,
                feat_hw):
        x = self.norm0(self.tsa(x, bev_pos, bev_hw))
        x = self.norm1(self.sca(x, cam_feats, ref_cam, bev_mask, feat_hw))
        x = self.ffn_fc2(F.relu(self.ffn_fc1(x))) + x
        return self.norm2(x)


class RefBEVFormer(nn.Module):
    """(N, M, H, W, 3) images + calibration -> (N, bev_h, bev_w, C) BEV,
    the reference's only_bev path key for key."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = self.cfg = config
        self.dim = dim = cfg.get("dim", 256)
        self.bev_h = cfg.get("bev_h", 128)
        self.bev_w = cfg.get("bev_w", self.bev_h)
        self.d_pillar = cfg.get("num_points_in_pillar", 4)
        self.pc_range = cfg.get(
            "pc_range", [-102.4, -102.4, -5.0, 102.4, 102.4, 3.0])
        num_cams = cfg.get("num_cams", 4)
        self.backbone = ResNetEncoder(arch=cfg.get("backbone", "resnet50"),
                                      id_pick=(cfg.get("stage", 4),),
                                      torch_padding=True)
        fpn = cfg.get("fpn_channels", dim)
        # a single-level FPN: lateral 1x1 + 3x3 output conv
        self.neck_lateral = Conv(self.backbone.picked_channels[0], fpn, 1)
        self.neck_fpn = Conv(fpn, fpn, 3)
        # the level and camera embeddings, the learned BEV queries and
        # their positional encoding (columns: x features, then rows)
        self.cams_embeds = nn.Parameter(torch.empty(num_cams, dim))
        self.level_embeds = nn.Parameter(torch.empty(1, dim))
        self.bev_embedding = nn.Parameter(
            torch.empty(self.bev_h * self.bev_w, dim))
        self.row_embed = nn.Parameter(torch.empty(self.bev_h, dim // 2))
        self.col_embed = nn.Parameter(torch.empty(self.bev_w, dim // 2))
        self.num_layers = cfg.get("num_layers", 3)
        for i in range(self.num_layers):
            self.add_module(f"layer{i}", RefBEVFormerLayer(
                dim, cfg.get("ffn_dim", 2 * dim)))

    def reset_parameters(self, gen):
        for p in (self.cams_embeds, self.level_embeds, self.bev_embedding):
            normal_(p, 1.0, gen)
        uniform_(self.row_embed, 0.0, 1.0, gen)
        uniform_(self.col_embed, 0.0, 1.0, gen)

    def forward(self, images, intrinsics, extrinsics):
        cfg = self.cfg
        dim, bev_h, bev_w = self.dim, self.bev_h, self.bev_w
        n, m = images.shape[:2]
        img_hw = tuple(cfg.get("img_shape", images.shape[2:4]))
        feats = self.backbone(images.reshape(n * m, *images.shape[2:]).to(
            torch.float32))
        feats = self.neck_fpn(self.neck_lateral(feats))
        fh, fw = feats.shape[1:3]
        cam_feats = (feats.reshape(n, m, fh * fw, -1)
                     + self.cams_embeds[None, :, None, :]
                     + self.level_embeds[0][None, None, None, :])
        half = dim // 2
        pos = torch.cat([
            self.col_embed[None, :, :].expand(bev_h, bev_w, half),
            self.row_embed[:, None, :].expand(bev_h, bev_w, half),
        ], -1).reshape(1, bev_h * bev_w, dim)
        l2i = lidar2img_ref(intrinsics, extrinsics)
        pc = self.pc_range
        ref_3d = _reference_points_3d(bev_h, bev_w, self.d_pillar,
                                      pc[5] - pc[2], images.device)
        ref_cam, bev_mask = point_sampling(ref_3d, pc, l2i, img_hw)
        x = self.bev_embedding[None].expand(n, bev_h * bev_w, dim)
        for i in range(self.num_layers):
            x = getattr(self, f"layer{i}")(x, pos, cam_feats, ref_cam,
                                           bev_mask, (bev_h, bev_w),
                                           (fh, fw))
        return x.reshape(n, bev_h, bev_w, dim)


class RefBEVFormerDetector(nn.Module):
    """The reference's standalone ``bevformer_wrapper`` late-fusion
    camera detector: the trunk -> NaiveDecoder (no upsampling, BatchNorm
    eps 1e-5) -> cls / reg heads, on the ego slot (slot 0) of the tools'
    batch.  A new model is in eval mode."""

    def __init__(self, config: dict):
        super().__init__()
        from .layers import DetectionHead, NaiveDecoder

        cfg = self.config = config
        self.bevformer = RefBEVFormer(cfg["camera"])
        dec = cfg.get("decoder", {"num_layer": 2, "num_ch_dec": [256, 256]})
        self.decoder = NaiveDecoder(self.bevformer.dim, dec["num_layer"],
                                    tuple(dec["num_ch_dec"]),
                                    use_upsample=False, bn_eps=1e-5)
        self.head = DetectionHead(dec["num_ch_dec"][0], cfg["anchor_number"])
        self.eval()

    def forward(self, batch: dict) -> dict:
        cams = batch["camera"]
        b, l = cams.shape[:2]

        def flat(key):
            v = batch[key]
            return v.reshape(b * l, *v.shape[2:])

        bev = self.bevformer(flat("camera"), flat("intrinsics"),
                             flat("extrinsics"))
        bev = bev.reshape(b, l, *bev.shape[1:])[:, 0]  # the ego only
        psm, rm = self.head(self.decoder(bev))
        return {"psm": psm.permute(0, 3, 1, 2), "rm": rm.permute(0, 3, 1, 2)}


class RefBEVFormerCameraEncoder(nn.Module):
    """The camera-encoder slot's adapter: (images, intrinsics,
    extrinsics) -> the BEV of :class:`RefBEVFormer` (the reference
    wrapper's features under ``set_return_features``; its decoder and
    heads are dead weight in the flagship and not built)."""

    def __init__(self, config: dict):
        super().__init__()
        self.bevformer = RefBEVFormer(config)

    def forward(self, images, intrinsics, extrinsics):
        return self.bevformer(images, intrinsics, extrinsics)
