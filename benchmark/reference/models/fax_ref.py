"""Reference-faithful FAX / SinBEVT camera encoder (copy of the port's
``models/fax_ref.py`` plain path, cut to what the ``hmvit_fax_ref``
configuration runs).

The released ``FaxFusedTransformer``'s camera branch parameter for
parameter: a multi-scale ResNet trunk, the FAXModule (a learned BEV
prior refined at each image scale by CrossViewSwapAttention: local-window
then local-to-global window cross attention with camera-geometry key
embeddings from I^-1 / E^-1 rays; bottleneck blocks and the
pixel-unshuffle downsample between scales; a full-map self attention
with a learned relative-position bias), then ``out_proj`` and
``NaiveDecoder``.  The geometry is float32 and written out elementwise
(never TF32); attention scores, softmax and the weighted sum are
float32.

Departures from the port's file:

* no tracer marks and no score counter (the port's ``tracing`` calls);
* no ``reset_parameters`` (the benchmark loads every weight);
* the pixel grid is made at each call, not cached per device, and the
  BEV grids' (x, y) are moved to the device at each call;
* ``_GeometryEmbedding`` always has image features (the CVT twin's
  option is not copied), and the cross-view block always has its skips;
* no ``config`` default in the FAXModule's forward: the encoder builds
  the module's configuration from the features it gets and hands it in;
  no per-scale ``heads_list`` / ``dim_head_list`` keys (every scale takes
  ``heads`` and ``dim_head``).

``CAMERA_ENCODER`` is what ``models/hmvit.py`` builds for ``encoder:
fax_ref``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import BatchNorm, Conv, Dense, LayerNorm
from .layers import NaiveDecoder
from .resnet import ResNetEncoder


def generate_grid(height: int, width: int) -> np.ndarray:
    """The reference ``generate_grid`` with its swapped meshgrid naming:
    (1, 3, W, H) float32, rows (x, y, 1)."""
    xs = np.linspace(0, 1, width, dtype=np.float32)
    ys = np.linspace(0, 1, height, dtype=np.float32)
    yy, xx = np.meshgrid(xs, ys, indexing="ij")  # each (W, H)
    indices = np.stack([xx, yy], 0)
    ones = np.ones((1,) + indices.shape[1:], np.float32)
    return np.concatenate([indices, ones], 0)[None]


def pixel_grid(fh: int, fw: int, img_h: int, img_w: int,
               device) -> torch.Tensor:
    """The feature pixels' image coordinates: :func:`generate_grid` of
    (fh, fw) with its rows scaled by the image width and height, (3, fw,
    fh) float32 on ``device``."""
    pixel = generate_grid(fh, fw)[0]
    pixel[0] *= img_w
    pixel[1] *= img_h
    return torch.from_numpy(pixel).to(device, torch.float32)


def get_view_matrix(h, w, h_meters, w_meters, offset) -> np.ndarray:
    """BEV pixel -> ego metres, (3, 3) float32."""
    sh = h / h_meters
    sw = w / w_meters
    return np.array([
        [0.0, -sw, w / 2.0],
        [-sh, 0.0, h * offset + h / 2.0],
        [0.0, 0.0, 1.0],
    ], np.float32)


def bev_grids(bev_height, bev_width, h_meters, w_meters, offset,
              upsample_scales):
    """The egocentric BEV coordinate grid of each scale: a list of
    (3, h, w) float32 arrays."""
    v = get_view_matrix(bev_height, bev_width, h_meters, w_meters, offset)
    v_inv = np.linalg.inv(v)
    grids = []
    for scale in upsample_scales:
        h, w = bev_height // scale, bev_width // scale
        grid = generate_grid(h, w)[0].copy()
        grid[0] = bev_width * grid[0]
        grid[1] = bev_height * grid[1]
        flat = v_inv @ grid.reshape(3, -1)
        grids.append(flat.reshape(3, *grid.shape[1:]))
    return grids


def mm(a, b):
    """(..., i, j) x (..., j, k) -> (..., i, k), elementwise in the
    operands' type (exact float32, no matmul backend)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def inv(m):
    """float32 inverse without a host read (``inv_ex``)."""
    return torch.linalg.inv_ex(m.to(torch.float32))[0]


def unit(t):
    """t over its last axis's norm + 1e-7."""
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-7)


def einsum_f32(eq: str, *operands):
    """``jnp.einsum(eq, ..., preferred_element_type=float32)``: the
    operands widened to float32."""
    return torch.einsum(eq, *(o.to(torch.float32) for o in operands))


class BEVEmbedding(nn.Module):
    """The learned BEV prior (dim, h0, w0) and the per-scale coordinate
    grids (numpy, float32)."""

    def __init__(self, dim: int, bev_height: int, bev_width: int,
                 h_meters: float, w_meters: float, offset: float,
                 upsample_scales):
        super().__init__()
        self.grids = bev_grids(bev_height, bev_width, h_meters, w_meters,
                               offset, tuple(upsample_scales))
        h0 = bev_height // upsample_scales[0]
        w0 = bev_width // upsample_scales[0]
        self.learned_features = nn.Parameter(torch.empty(dim, h0, w0))


def _rearrange_windows(t, w1, w2):
    """(B, N, D, (x w1), (y w2)) -> (B, N, x, y, w1, w2, D)."""
    b, n, d, h, w = t.shape
    x, y = h // w1, w // w2
    t = t.reshape(b, n, d, x, w1, y, w2)
    return t.permute(0, 1, 3, 5, 4, 6, 2)


def _merge_windows(t):
    """(B, x, y, w1, w2, D) -> (B, (x w1), (y w2), D)."""
    b, x, y, w1, w2, d = t.shape
    return t.permute(0, 1, 3, 2, 4, 5).reshape(b, x * w1, y * w2, d)


def _grid_partition(t, w1, w2):
    """(B, N, D, (w1 x), (w2 y)) -> (B, N, x, y, w1, w2, D)."""
    b, n, d, h, w = t.shape
    x, y = h // w1, w // w2
    t = t.reshape(b, n, d, w1, x, w2, y)
    return t.permute(0, 1, 4, 6, 3, 5, 2)


class RefCrossWinAttention(nn.Module):
    """Per-window cross attention: BEV window queries x every camera's
    window tokens ([LayerNorm, Dense] projections, heads folded into the
    batch), ``proj``, then the camera axis reduced by its mean."""

    def __init__(self, dim: int, heads: int, dim_head: int, qkv_bias: bool):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        for name in ("to_q", "to_k", "to_v"):
            self.add_module(f"{name}_norm", LayerNorm(dim))
            self.add_module(name, Dense(dim, inner, use_bias=qkv_bias))
        self.proj = Dense(inner, dim)

    def project(self, t, name):
        return getattr(self, name)(getattr(self, f"{name}_norm")(t))

    def forward(self, q, k, v, skip):
        """q (b, n, x, y, w1, w2, d); k / v (b, n, x, y, w1', w2', d) ->
        (b, x, y, w1, w2, d)."""
        b, n, qx, qy, qw1, qw2, _ = q.shape
        heads, dh = self.heads, self.dim_head
        inner = heads * dh

        def flat(t):
            bb, nn_, x, y, w1, w2 = t.shape[:6]
            t = t.permute(0, 2, 3, 1, 4, 5, 6)  # b x y n w1 w2 d
            return t.reshape(bb, x * y, nn_ * w1 * w2, t.shape[-1])

        def heads_to_batch(t):
            bb, l, tok, _ = t.shape
            t = t.reshape(bb, l, tok, heads, dh)
            return t.permute(0, 3, 1, 2, 4).reshape(bb * heads, l, tok, dh)

        qh = heads_to_batch(self.project(flat(q), "to_q"))
        kh = heads_to_batch(self.project(flat(k), "to_k"))
        vh = heads_to_batch(self.project(flat(v), "to_v"))
        dot = dh ** -0.5 * einsum_f32("blqd,blkd->blqk", qh, kh)
        a = einsum_f32("blqk,blkd->blqd", torch.softmax(dot, -1), vh)
        a = a.reshape(b, heads, qx * qy, n * qw1 * qw2, dh)
        a = a.permute(0, 2, 3, 1, 4).reshape(b, qx * qy, n * qw1 * qw2,
                                             inner)
        z = self.proj(a).reshape(b, qx, qy, n, qw1, qw2, -1)
        z = z.permute(0, 3, 1, 2, 4, 5, 6).mean(1)  # reduce the cameras
        return z + skip


def _bn_relu_conv(owner, name, t):
    """BatchNorm ``<name>_bn`` -> ReLU -> the bias-free 1x1 conv
    ``name``."""
    t = F.relu(getattr(owner, f"{name}_bn")(t))
    return getattr(owner, name)(t)


def _mlp(owner, name, t):
    h = F.gelu(getattr(owner, f"{name}_fc1")(t))  # exact (erf) GELU
    return getattr(owner, f"{name}_fc2")(h)


class RefCrossViewSwapAttention(nn.Module):
    """CrossViewSwapAttention: the camera-geometry embeddings
    (``cam_embed``: the camera centre, E^-1's translation column;
    ``img_embed``: each feature pixel's ray E^-1 [I^-1 (u, v, 1), 1]; the
    key / value projections ``feature_proj`` / ``feature_linear``), the
    BEV positional embedding when ``bev_embed_flag``, local-window then
    local-to-global window cross attention with skips, two MLPs and a
    final LayerNorm."""

    def __init__(self, feat_dim: int, dim: int, qkv_bias: bool, heads: int,
                 dim_head: int, bev_embed_flag: bool):
        super().__init__()
        self.dim = dim
        self.bev_embed_flag = bev_embed_flag
        self.cam_embed = Conv(4, dim, 1, use_bias=False)
        self.img_embed = Conv(4, dim, 1, use_bias=False)
        for name in ("feature_proj", "feature_linear"):
            self.add_module(f"{name}_bn", BatchNorm(feat_dim, 1e-5, 0.9))
            self.add_module(name, Conv(feat_dim, dim, 1, use_bias=False))
        if bev_embed_flag:
            self.bev_embed = Conv(2, dim, 1)
        self.cross_win_attend_1 = RefCrossWinAttention(dim, heads, dim_head,
                                                       qkv_bias)
        self.cross_win_attend_2 = RefCrossWinAttention(dim, heads, dim_head,
                                                       qkv_bias)
        for name in ("prenorm_1", "prenorm_2", "postnorm"):
            self.add_module(name, LayerNorm(dim))
        for name in ("mlp_1", "mlp_2"):
            self.add_module(f"{name}_fc1", Dense(dim, 2 * dim))
            self.add_module(f"{name}_fc2", Dense(2 * dim, dim))

    def embed(self, feature, i_inv, e_inv, image_hw):
        """feature (bl, n, feat_dim, h, w), i_inv (bl, n, 3, 3), e_inv
        (bl, n, 4, 4) -> (c_embed (bl n, 1, 1, d), key (bl, n, d, h, w),
        value (bl, n, d, h, w))."""
        bl, n, feat_dim, fh, fw = feature.shape
        pix = pixel_grid(fh, fw, *image_hw, feature.device)
        ph, pw = pix.shape[1:]
        pix = pix.reshape(3, ph * pw)
        c_embed = self.cam_embed(e_inv[..., -1:].reshape(bl * n, 1, 1, 4))
        cam = mm(i_inv, pix)  # (bl, n, 3, hw)
        cam = torch.cat([cam, torch.ones_like(cam[:, :, :1])], 2)
        d_ray = mm(e_inv, cam)
        d_flat = d_ray.reshape(bl * n, 4, ph, pw).permute(0, 2, 3, 1)
        img_embed = unit(self.img_embed(d_flat) - c_embed)
        feature_flat = feature.reshape(bl * n, feat_dim, fh, fw).permute(
            0, 2, 3, 1)
        key_flat = img_embed + _bn_relu_conv(self, "feature_proj",
                                             feature_flat)
        val_flat = _bn_relu_conv(self, "feature_linear", feature_flat)
        key = key_flat.permute(0, 3, 1, 2).reshape(bl, n, self.dim, ph, pw)
        val = val_flat.permute(0, 3, 1, 2).reshape(bl, n, self.dim, ph, pw)
        return c_embed, key, val

    def bev_query_pos(self, bev_grid, c_embed, bl: int, n: int):
        """The BEV positional embedding (bl, n, d, H, W): ``bev_embed`` of
        the grid's (x, y) minus the camera centre's, normalised."""
        world = torch.from_numpy(np.ascontiguousarray(
            bev_grid[:2].transpose(1, 2, 0)[None])).to(c_embed.device,
                                                       torch.float32)
        big_h, big_w = world.shape[1:3]
        w_embed = self.bev_embed(world)
        bev_embed = unit(w_embed - c_embed.reshape(bl * n, 1, 1, self.dim))
        return bev_embed.reshape(bl, n, big_h, big_w, self.dim).permute(
            0, 1, 4, 2, 3)

    def forward(self, x, bev_grid, feature, i_inv, e_inv, image_hw,
                q_win_size, feat_win_size):
        """x (bl, d, H, W); bev_grid (3, H, W) numpy; feature (bl, n,
        feat_dim, h, w); i_inv (bl, n, 3, 3); e_inv (bl, n, 4, 4) ->
        (bl, d, H, W)."""
        bl, n = feature.shape[:2]
        big_h, big_w = x.shape[2], x.shape[3]
        qw1, qw2 = q_win_size
        fw1, fw2 = feat_win_size
        c_embed, key, val = self.embed(feature, i_inv, e_inv, image_hw)
        if self.bev_embed_flag:
            query = self.bev_query_pos(bev_grid, c_embed, bl, n) + x[:, None]
        else:
            query = x[:, None].expand(bl, n, self.dim, big_h, big_w)

        def pad_div(t):
            h, w = t.shape[-2], t.shape[-1]
            padh, padw = (fw1 - h % fw1) % fw1, (fw2 - w % fw2) % fw2
            return F.pad(t, (0, padw, 0, padh)) if padh or padw else t

        key, val = pad_div(key), pad_div(val)
        # local to local: (x w1)(y w2) windows on both sides
        skip1 = _rearrange_windows(x[:, None], qw1, qw2)[:, 0]
        q1 = self.cross_win_attend_1(
            _rearrange_windows(query, qw1, qw2),
            _rearrange_windows(key, fw1, fw2),
            _rearrange_windows(val, fw1, fw2), skip1)
        q1 = _merge_windows(q1)
        q1 = q1 + _mlp(self, "mlp_1", self.prenorm_1(q1))
        # local to global: the queries windowed, the keys and values
        # grid-partitioned (w1 x)(w2 y)
        q2_in = q1[:, None].expand(bl, n, big_h, big_w, -1).permute(
            0, 1, 4, 2, 3)
        skip2 = _rearrange_windows(q1.permute(0, 3, 1, 2)[:, None], qw1,
                                   qw2)[:, 0]
        q2 = self.cross_win_attend_2(
            _rearrange_windows(q2_in, qw1, qw2),
            _grid_partition(key, fw1, fw2), _grid_partition(val, fw1, fw2),
            skip2)
        q2 = _merge_windows(q2)
        q2 = q2 + _mlp(self, "mlp_2", self.prenorm_2(q2))
        return self.postnorm(q2).permute(0, 3, 1, 2)


def relative_index(ws: int) -> np.ndarray:
    """(ws^2, ws^2) index into the (2 ws - 1)^2 relative-position table."""
    pos = np.arange(ws)
    grid = np.stack(np.meshgrid(pos, pos, indexing="ij"))
    grid = grid.reshape(2, -1).T
    rel = grid[:, None] - grid[None]
    rel += ws - 1
    return (rel * np.array([2 * ws - 1, 1])).sum(-1)


class RefAttention(nn.Module):
    """Full-map self attention with a relative-position bias (the
    window is the whole map: ``window_size`` equals its side)."""

    def __init__(self, dim: int, dim_head: int, window_size: int):
        super().__init__()
        self.dim, self.dim_head = dim, dim_head
        self.heads = dim // dim_head
        self.to_qkv = Dense(dim, 3 * dim, use_bias=False)
        self.to_out = Dense(dim, dim, use_bias=False)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, self.heads))
        self.register_buffer(
            "rel_index", torch.as_tensor(relative_index(window_size),
                                         dtype=torch.long), persistent=False)

    def forward(self, x):
        """x (b, d, h, w) -> (b, d, h, w)."""
        b, d, h, w = x.shape
        heads, dh = self.heads, self.dim_head
        t = x.permute(0, 2, 3, 1).reshape(b, h * w, d)
        q, k, v = self.to_qkv(t).chunk(3, dim=-1)

        def split_heads(u):
            return u.reshape(b, h * w, heads, dh).permute(0, 2, 1, 3)

        qh, kh, vh = map(split_heads, (q, k, v))
        sim = einsum_f32("bhid,bhjd->bhij", qh * dh ** -0.5, kh)
        bias = self.rel_pos_bias[self.rel_index]  # (T, T, heads)
        sim = sim + bias.permute(2, 0, 1)[None]
        out = einsum_f32("bhij,bhjd->bhid", torch.softmax(sim, -1), vh)
        out = out.permute(0, 2, 1, 3).reshape(b, h * w, self.dim)
        out = self.to_out(out)
        return out.reshape(b, h, w, self.dim).permute(0, 3, 1, 2)


class RefBottleneck(nn.Module):
    """torchvision's Bottleneck(c, c // 4): 1x1 -> 3x3 -> 1x1 with
    BatchNorm + ReLU, identity residual; (b, c, h, w) in and out."""

    def __init__(self, channels: int):
        super().__init__()
        width = channels // 4
        self.conv1 = Conv(channels, width, 1, use_bias=False)
        self.conv2 = Conv(width, width, 3, padding=1, use_bias=False)
        self.conv3 = Conv(width, channels, 1, use_bias=False)
        for i, c in ((1, width), (2, width), (3, channels)):
            self.add_module(f"bn{i}", BatchNorm(c, 1e-5, 0.9))

    def forward(self, x):
        t = x.permute(0, 2, 3, 1)
        h = F.relu(self.bn1(self.conv1(t)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(t + h).permute(0, 3, 1, 2)


class RefDownsample(nn.Module):
    """Between scales: conv (d -> d / 4) -> PixelUnshuffle(2) -> 3x3 conv
    -> BatchNorm -> ReLU -> 1x1 conv -> BatchNorm; (b, c, h, w) in and
    out."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv_pre = Conv(dim_in, dim_in // 4, 3, padding=1,
                             use_bias=False)
        self.conv_mid = Conv(dim_in // 4 * 4, dim_out, 3, padding=1,
                             use_bias=False)
        self.bn_mid = BatchNorm(dim_out, 1e-5, 0.9)
        self.conv_post = Conv(dim_out, dim_out, 1, use_bias=False)
        self.bn_post = BatchNorm(dim_out, 1e-5, 0.9)

    def forward(self, x):
        t = self.conv_pre(x.permute(0, 2, 3, 1))
        # PixelUnshuffle(2): channel index c * 4 + i * 2 + j
        b, h, w, c = t.shape
        t = t.reshape(b, h // 2, 2, w // 2, 2, c)
        t = t.permute(0, 1, 3, 5, 2, 4).reshape(b, h // 2, w // 2, c * 4)
        t = F.relu(self.bn_mid(self.conv_mid(t)))
        t = self.bn_post(self.conv_post(t))
        return t.permute(0, 3, 1, 2)


class RefFAXModule(nn.Module):
    """The FAXModule: a learned BEV prior refined per image scale by
    CrossViewSwapAttention, bottleneck layers and the pixel-unshuffle
    downsample, then the full-map self attention.  ``config`` holds the
    reference's keys (dim and middle per scale, bev_embedding,
    cross_view, cross_view_swap, self_attn, backbone_output_shape: the
    (_, _, _, c, h, w) of each scale's features)."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        dims, middle = cfg["dim"], cfg["middle"]
        cv, cvs = cfg["cross_view"], cfg["cross_view_swap"]
        be = cfg["bev_embedding"]
        shapes = cfg["backbone_output_shape"]
        self.bev_embedding = BEVEmbedding(
            dims[0], be["bev_height"], be["bev_width"], be["h_meters"],
            be["w_meters"], be["offset"], tuple(be["upsample_scales"]))
        self.middle = list(middle)
        for i, shape in enumerate(shapes):
            self.add_module(f"cross_views_{i}", RefCrossViewSwapAttention(
                feat_dim=shape[3], dim=dims[i], qkv_bias=cv["qkv_bias"],
                heads=cv["heads"][i], dim_head=cv["dim_head"][i],
                bev_embed_flag=cvs["bev_embedding_flag"][i]))
            for j in range(middle[i]):
                self.add_module(f"layers_{i}_{j}", RefBottleneck(dims[i]))
            if i < len(shapes) - 1:
                self.add_module(f"downsample_layers_{i}",
                                RefDownsample(dims[i], dims[i + 1]))
        sa = cfg["self_attn"]
        self.self_attn = RefAttention(dims[-1], sa["dim_head"],
                                      sa["window_size"])

    def forward(self, features, i_inv, e_inv, cfg: dict):
        """features: each scale's (bl, n, c, h, w); i_inv (bl, n, 3, 3);
        e_inv (bl, n, 4, 4) -> (bl, d, H, W).  ``cfg`` supplies the image
        size and the window sizes."""
        cv, cvs = cfg["cross_view"], cfg["cross_view_swap"]
        prior = self.bev_embedding.learned_features
        bl = features[0].shape[0]
        x = prior[None].expand(bl, *prior.shape)
        for i, feature in enumerate(features):
            x = getattr(self, f"cross_views_{i}")(
                x, self.bev_embedding.grids[i], feature, i_inv, e_inv,
                (cv["image_height"], cv["image_width"]),
                tuple(cvs["q_win_size"][i]), tuple(cvs["feat_win_size"][i]))
            for j in range(self.middle[i]):
                x = getattr(self, f"layers_{i}_{j}")(x)
            if i < len(features) - 1:
                x = getattr(self, f"downsample_layers_{i}")(x)
        return self.self_attn(x)


class FAXRefCameraEncoder(nn.Module):
    """The camera config's ``encoder: fax_ref``: a multi-scale ResNet
    trunk (``backbone``, ``id_pick``) and the FAXModule, on the encoders'
    interface ((N, M, H, W, 3) images + calibration -> (N, H', W',
    out_dim) NHWC BEV)."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = self.cfg = config
        self.trunk = ResNetEncoder(arch=cfg.get("backbone", "resnet34"),
                                   id_pick=tuple(cfg.get("id_pick", (2, 3))))
        self.fax = RefFAXModule(self.fax_config(
            [(c, 1, 1) for c in self.trunk.picked_channels], 1, 1))
        dim = int(cfg.get("dim", 128))
        out_dim = int(cfg.get("out_dim", 256))
        self.out_proj = Dense(dim, out_dim)
        up = int(cfg.get("decoder_layers", 2))
        if up:
            self.NaiveDecoder_0 = NaiveDecoder(out_dim, up, [out_dim] * up,
                                               use_upsample=True)

    def fax_config(self, shapes, img_h: int, img_w: int) -> dict:
        """The FAXModule's config for features of (c, h, w) ``shapes`` and
        (img_h, img_w) images."""
        cfg = self.cfg
        n_scales = len(shapes)
        dim = int(cfg.get("dim", 128))
        bev = int(cfg.get("bev_size", 32))
        win = int(cfg.get("window", 4))
        return {
            "dim": [dim] * n_scales,
            "middle": list(cfg.get("middle", [2] * n_scales)),
            "backbone_output_shape": [(1, 1, 1, *s) for s in shapes],
            "bev_embedding": {
                # the prior lives at the first scale; later scales halve it
                "bev_height": bev * (2 ** (n_scales - 1)),
                "bev_width": bev * (2 ** (n_scales - 1)),
                "h_meters": float(cfg.get("bev_range", 100.0)),
                "w_meters": float(cfg.get("bev_range", 100.0)),
                "offset": 0.0,
                "upsample_scales": [2 ** (n_scales - 1 - i)
                                    for i in range(n_scales)][::-1],
            },
            "cross_view": {
                "image_height": img_h, "image_width": img_w,
                "qkv_bias": True,
                "heads": [cfg.get("heads", 4)] * n_scales,
                "dim_head": [cfg.get("dim_head", 32)] * n_scales,
            },
            "cross_view_swap": {
                "q_win_size": [[win, win]] * n_scales,
                # equal window counts on both sides: feat_win = fh * win /
                # the scale's BEV side
                "feat_win_size": [
                    [max(1, shapes[i][1] * win
                         // (bev * (2 ** (n_scales - 1 - i))))] * 2
                    for i in range(n_scales)],
                "bev_embedding_flag": [i == 0 for i in range(n_scales)],
            },
            "self_attn": {"dim_head": cfg.get("dim_head", 32),
                          "window_size": bev},
        }

    def forward(self, images, intrinsics, extrinsics):
        n, m, img_h, img_w, _ = images.shape
        feats = self.trunk(images.reshape(n * m, img_h, img_w, 3))
        if not isinstance(feats, (list, tuple)):
            feats = [feats]
        # the trunk's NHWC outputs -> the reference's (n, m, c, h, w)
        features = [f.reshape(n, m, *f.shape[1:]).permute(0, 1, 4, 2, 3)
                    for f in feats]
        shapes = [tuple(f.shape[2:]) for f in features]
        i_inv = inv(intrinsics.reshape(n, m, 3, 3))
        e_inv = inv(extrinsics.reshape(n, m, 4, 4))
        x = self.fax(features, i_inv, e_inv,
                     self.fax_config(shapes, img_h, img_w))
        x = self.out_proj(x.permute(0, 2, 3, 1))
        decoder = getattr(self, "NaiveDecoder_0", None)
        return x if decoder is None else decoder(x)


CAMERA_ENCODER = FAXRefCameraEncoder
