"""Reference-faithful CVT (Cross-View Transformer) blocks (port of
``hmvit_tpu/models/cvt_ref.py``).

The structural twins of the reference's CVT camera -> BEV stack,
parameter for parameter, so that a reference checkpoint ports
(``tools/convert_checkpoint.py --core_method cvt``): the single-grid BEV
embedding, the global cross attention (per-camera queries, the camera
axis folded into the key tokens), the cross-view attention with FAX's
I^-1 / E^-1 geometry embeddings, and the CrossViewModule (per-scale
attention + bottleneck refinement).  The serving encoder stays
:mod:`hmvit_tpu_torch.models.cvt`; this one is the camera config's
``encoder: cvt_ref``.  Plain PyTorch, float32 geometry and attention
arithmetic as in :mod:`hmvit_tpu_torch.models.fax_ref`.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import Conv, Dense, LayerNorm, normal_
from .fax_ref import (
    RefBottleneck,
    _Attend,
    _GeometryEmbedding,
    calibration_inverses,
    einsum_f32,
    generate_grid,
    get_view_matrix,
    reference_layout,
)


def cvt_bev_grid(bev_height, bev_width, h_meters, w_meters, offset,
                 num_decoder_blocks):
    """The single egocentric BEV grid at 1 / 2^blocks resolution, (3, h,
    w) float32."""
    h = bev_height // (2 ** num_decoder_blocks)
    w = bev_width // (2 ** num_decoder_blocks)
    grid = generate_grid(h, w)[0].copy()
    grid[0] = bev_width * grid[0]
    grid[1] = bev_height * grid[1]
    v = get_view_matrix(bev_height, bev_width, h_meters, w_meters, offset)
    v_inv = np.linalg.inv(v)
    flat = v_inv @ grid.reshape(3, -1)
    return flat.reshape(3, *grid.shape[1:])


class RefCrossAttention(_Attend):
    """Global cross attention: per-camera BEV queries, one softmax over
    every camera's image tokens, then the built-in prenorm -> MLP ->
    postnorm tail."""

    def __init__(self, dim: int, heads: int, dim_head: int, qkv_bias: bool):
        super().__init__(dim, heads, dim_head, qkv_bias)
        self.dim = dim
        self.prenorm = LayerNorm(dim)
        self.mlp_fc1 = Dense(dim, 2 * dim)
        self.mlp_fc2 = Dense(2 * dim, dim)
        self.postnorm = LayerNorm(dim)

    def forward(self, q, k, v, skip=None):
        """q (b, n, d, H, W); k / v (b, n, d, h, w) -> (b, d, H, W)."""
        b, n, _, big_h, big_w = q.shape
        h, w = k.shape[3], k.shape[4]
        heads, dh = self.heads, self.dim_head
        inner = heads * dh
        qf = q.permute(0, 1, 3, 4, 2).reshape(b, n, big_h * big_w, self.dim)
        kf = k.permute(0, 1, 3, 4, 2).reshape(b, n, h * w, self.dim)
        vf = v.permute(0, 1, 3, 4, 2).reshape(b, n * h * w, self.dim)

        def heads_to_batch(t):
            # 'b ... (m d) -> (b m) ... d'
            t2 = t.reshape(*t.shape[:-1], heads, dh)
            nd = t2.ndim
            t2 = t2.permute(0, nd - 2, *range(1, nd - 2), nd - 1)
            return t2.reshape(b * heads, *t2.shape[2:])

        qh = heads_to_batch(self.project(qf, "to_q"))  # (bm, n, Q, d)
        kh = heads_to_batch(self.project(kf, "to_k"))  # (bm, n, K, d)
        vh = heads_to_batch(self.project(vf, "to_v"))  # (bm, n K, d)
        dot = dh ** -0.5 * einsum_f32("bnqd,bnkd->bnqk", qh, kh)
        dot = dot.permute(0, 2, 1, 3).reshape(b * heads, big_h * big_w,
                                              n * h * w)
        a = einsum_f32("bqk,bkd->bqd", torch.softmax(dot, -1), vh)
        a = a.reshape(b, heads, big_h * big_w, dh)
        a = a.permute(0, 2, 1, 3).reshape(b, big_h * big_w, inner)
        z = self.proj(a)
        if skip is not None:
            z = z + skip.permute(0, 2, 3, 1).reshape(b, big_h * big_w,
                                                     self.dim)
        z = self.prenorm(z)
        z = z + self.mlp_fc2(F.gelu(self.mlp_fc1(z)))  # exact (erf) GELU
        z = self.postnorm(z)
        return z.reshape(b, big_h, big_w, self.dim).permute(0, 3, 1, 2)


class RefCrossViewAttention(_GeometryEmbedding):
    """CrossViewAttention: the camera-geometry key / query embeddings and
    the global cross attention."""

    def __init__(self, feat_dim: int, dim: int, qkv_bias: bool, heads: int,
                 dim_head: int, skip: bool = True,
                 no_image_features: bool = False):
        super().__init__(feat_dim, dim, image_features=not no_image_features)
        self.skip = skip
        self.bev_embed = Conv(2, dim, 1)
        self.cross_attend = RefCrossAttention(dim, heads, dim_head, qkv_bias)

    def forward(self, x, bev_grid, feature, i_inv, e_inv, image_hw):
        """x (bl, d, H, W); bev_grid (3, H, W) numpy; feature (bl, n,
        feat_dim, h, w) -> (bl, d, H, W)."""
        bl, n = feature.shape[:2]
        c_embed, key, val = self.embed(feature, i_inv, e_inv, image_hw)
        query = self.bev_query_pos(bev_grid, c_embed, bl, n) + x[:, None]
        return self.cross_attend(query, key, val,
                                 skip=x if self.skip else None)


class RefCrossViewModule(nn.Module):
    """The CrossViewModule: a learned BEV prior refined per scale by
    CrossViewAttention and bottlenecks; every scale shares the one BEV
    grid.  ``config`` holds the reference's keys (dim, middle,
    bev_embedding with decoder_blocks, cross_view,
    backbone_output_shape)."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = self.config = config
        dim, middle = cfg["dim"], cfg["middle"]
        cv, be = cfg["cross_view"], cfg["bev_embedding"]
        self.sigma = be["sigma"]
        self.grid = cvt_bev_grid(be["bev_height"], be["bev_width"],
                                 be["h_meters"], be["w_meters"], be["offset"],
                                 len(be["decoder_blocks"]))
        self.bev_embedding_learned_features = nn.Parameter(
            torch.empty(dim, *self.grid.shape[1:]))
        self.middle = list(middle)
        for i, shape in enumerate(cfg["backbone_output_shape"]):
            self.add_module(f"cross_views_{i}", RefCrossViewAttention(
                feat_dim=shape[3], dim=dim, qkv_bias=cv["qkv_bias"],
                heads=cv["heads"], dim_head=cv["dim_head"],
                skip=cv.get("skip", True),
                no_image_features=cv.get("no_image_features", False)))
            for j in range(middle[i]):
                self.add_module(f"layers_{i}_{j}", RefBottleneck(dim))

    def reset_parameters(self, gen):
        normal_(self.bev_embedding_learned_features, self.sigma, gen)

    def forward(self, features, i_inv, e_inv, config: dict | None = None):
        """features: each scale's (bl, n, c, h, w) -> (bl, d, H, W);
        ``config`` (the module's own by default) supplies the image
        size."""
        cv = (config or self.config)["cross_view"]
        prior = self.bev_embedding_learned_features
        bl = features[0].shape[0]
        x = prior[None].expand(bl, *prior.shape)
        for i, feature in enumerate(features):
            x = getattr(self, f"cross_views_{i}")(
                x, self.grid, feature, i_inv, e_inv,
                (cv["image_height"], cv["image_width"]))
            for j in range(self.middle[i]):
                x = getattr(self, f"layers_{i}_{j}")(x)
        return x


class CVTRefCameraEncoder(nn.Module):
    """The camera config's ``encoder: cvt_ref``: a multi-scale ResNet
    trunk and the reference CrossViewModule, on the encoders' interface
    ((N, M, H, W, 3) images + calibration -> (N, H', W', out_dim) NHWC
    BEV)."""

    def __init__(self, config: dict):
        super().__init__()
        from .layers import NaiveDecoder
        from .resnet import ResNetEncoder

        cfg = self.cfg = config
        self.trunk = ResNetEncoder(arch=cfg.get("backbone", "resnet34"),
                                   id_pick=tuple(cfg.get("id_pick", (2, 3))))
        self.cvt = RefCrossViewModule(self.cvm_config(
            [(c, 1, 1) for c in self.trunk.picked_channels], 1, 1))
        dim = int(cfg.get("dim", 128))
        out_dim = int(cfg.get("out_dim", 256))
        self.out_proj = Dense(dim, out_dim)
        up = int(cfg.get("decoder_layers", 2))
        if up:
            self.NaiveDecoder_0 = NaiveDecoder(out_dim, up, [out_dim] * up,
                                               use_upsample=True)

    def cvm_config(self, shapes, img_h: int, img_w: int) -> dict:
        """The CrossViewModule's config for features of (c, h, w)
        ``shapes`` and (img_h, img_w) images (the JAX encoder's)."""
        cfg = self.cfg
        n_scales = len(shapes)
        bev = int(cfg.get("bev_size", 32))
        n_blocks = int(cfg.get("decoder_blocks", 1))
        return {
            "dim": int(cfg.get("dim", 128)),
            "middle": list(cfg.get("middle", [2] * n_scales)),
            "backbone_output_shape": [(1, 1, 1, *s) for s in shapes],
            "bev_embedding": {
                "sigma": 1.0,
                # one grid at the BEV resolution: bev_height /
                # 2**decoder_blocks == bev_size
                "bev_height": bev * (2 ** n_blocks),
                "bev_width": bev * (2 ** n_blocks),
                "h_meters": float(cfg.get("bev_range", 100.0)),
                "w_meters": float(cfg.get("bev_range", 100.0)),
                "offset": 0.0,
                "decoder_blocks": list(range(n_blocks)),
            },
            "cross_view": {
                "image_height": img_h, "image_width": img_w,
                "qkv_bias": True, "heads": int(cfg.get("heads", 4)),
                "dim_head": int(cfg.get("dim_head", 32)),
                "no_image_features": False, "skip": True,
            },
        }

    def forward(self, images, intrinsics, extrinsics):
        n, m, img_h, img_w, _ = images.shape
        features = reference_layout(
            self.trunk(images.reshape(n * m, img_h, img_w, 3)), n, m)
        shapes = [tuple(f.shape[2:]) for f in features]
        i_inv, e_inv = calibration_inverses(intrinsics, extrinsics, n, m)
        x = self.cvt(features, i_inv, e_inv,
                     config=self.cvm_config(shapes, img_h, img_w))
        x = self.out_proj(x.permute(0, 2, 3, 1))
        decoder = getattr(self, "NaiveDecoder_0", None)
        return x if decoder is None else decoder(x)
