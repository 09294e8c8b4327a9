"""H3GAT — heterogeneous local-window + global-grid graph attention fusion
(port of ``hmvit_tpu/models/hetero_fusion.py``).

As in the JAX package: modality-typed parameters are stacked on a type
axis, the relation transforms fold into the K/V projection per receiver
TYPE before the warp, the receiver axis is a batch dimension, and only
the senders' K/V are warped (queries live in the receiver's frame).

The block configuration routes each attention phase as the JAX module
does (``use_pallas``, ``use_stripe``):

* default: pair-warp kernel, then the stripe attention kernel (local
  phase) or the plain attention kernel (grid phase);
* ``use_stripe=False``: local phases window-split and run the plain
  attention kernel;
* ``use_pallas=False``: no kernel wrapper at all — the separable warp
  (or, with ``use_mxu_warp=False``, the gather warp) and the plain
  attention in PyTorch, the JAX package's XLA path.

Kernel wrappers run their plain twins here (``ops.use_kernel`` is
False).  The port's fused warp + attention (``use_fused_wa``), spatial
partitioning and tensor parallelism are not copied: no configuration of
the benchmark runs them.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..nn import DTYPES, Dense, Dropout, LayerNorm, normal_, xavier_uniform_
from ..ops import use_kernel
from ..ops.fused_warp import fused_pair_warp, pair_warp_coefficients
from ..ops.shear_warp import warp_bev_mxu
from ..ops.warp import roi_and_agent_mask, warp_bev_nhwc
from ..ops.window_attention import (
    fused_plain_window_attention,
    fused_stripe_window_attention,
    plain_window_attention_xla,
)
from ..utils.constants import device_constant
from ..utils.precision import dot_f32
from .layers import HeteroDense, HeteroFeedForward, HeteroLayerNorm


def pairwise_roi_mask(pairwise, agent_mask, hw, discrete_ratio,
                      downsample_rate):
    """(B, I, H, W, J) combined warped-ROI and agent-validity mask for
    every (receiver, sender) pair."""
    b, l = agent_mask.shape
    h, w = hw
    t_ij = pairwise.transpose(1, 2)
    mask = roi_and_agent_mask(
        b * l, l, h, w,
        agent_mask[:, None].expand(b, l, l).reshape(-1, l),
        t_ij.reshape(-1, l, 4, 4),
        discrete_ratio, downsample_rate)
    return mask.reshape(b, l, h, w, l)


def relative_position_index(win: int) -> np.ndarray:
    """(win^2, win^2) index into the (2*win-1)^2 relative-bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(win), np.arange(win), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += win - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 0] *= 2 * win - 1
    return rel.sum(-1)


def _window_split(x, win: int, style: str):
    """(..., H, W, C) -> (..., X, Y, win*win, C); 'local' = contiguous
    windows (x w1)(y w2), 'grid' = dilated grid (w1 x)(w2 y)."""
    *b, h, w, c = x.shape
    nb = len(b)
    if style == "local":
        x = x.reshape(*b, h // win, win, w // win, win, c).movedim(-3, -4)
    else:
        x = x.reshape(*b, win, h // win, win, w // win, c)
        x = x.permute(*range(nb), nb + 1, nb + 3, nb, nb + 2, nb + 4)
    return x.reshape(*b, h // win, w // win, win * win, c)


def _window_merge(x, win: int, style: str, h: int, w: int):
    """Inverse of :func:`_window_split`."""
    *b, nx, ny, _, c = x.shape
    nb = len(b)
    x = x.reshape(*b, nx, ny, win, win, c)
    if style == "local":
        return x.movedim(-3, -4).reshape(*b, h, w, c)
    x = x.permute(*range(nb), nb + 2, nb, nb + 3, nb + 1, nb + 4)
    return x.reshape(*b, h, w, c)


class HeteroWindowAttention(nn.Module):
    """Modality-typed windowed attention across agents, all receivers at
    once.  x (B, L, H, W, C) layer-normed per-agent maps in their own
    frames; mode (B, L) 0 = camera, 1 = lidar; pairwise (B, L, L, 4, 4)
    with pairwise[:, j, i] mapping j's frame into i's.  Returns the
    (B, I, H, W, C) message for each receiver."""

    def __init__(self, dim: int, dim_head: int = 32, window: int = 8,
                 style: str = "local", num_types: int = 2,
                 discrete_ratio: float = 0.4, downsample_rate: float = 4.0,
                 exclude_self: bool = False,
                 compute_dtype: str = "float32", use_pallas: bool = True,
                 use_stripe: bool = True, use_mxu_warp: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.dim, self.dim_head, self.window = dim, dim_head, window
        self.style, self.num_types = style, num_types
        self.discrete_ratio = discrete_ratio
        self.downsample_rate = downsample_rate
        self.exclude_self = exclude_self
        self.use_pallas, self.use_stripe = use_pallas, use_stripe
        self.use_mxu_warp = use_mxu_warp
        self.compute_dtype = DTYPES[compute_dtype]
        heads = dim // dim_head
        self.to_q = HeteroDense(dim, dim, num_types)
        self.to_k = HeteroDense(dim, dim, num_types)
        self.to_v = HeteroDense(dim, dim, num_types)
        self.to_out = HeteroDense(dim, dim, num_types)
        self.Dropout_0 = Dropout(dropout)
        num_rel = num_types ** 2
        self.relation_att = nn.Parameter(
            torch.empty(num_rel, heads, dim_head, dim_head))
        self.relation_msg = nn.Parameter(
            torch.empty(num_rel, heads, dim_head, dim_head))
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.register_buffer(
            "rel_index",
            torch.as_tensor(relative_position_index(window), dtype=torch.long),
            persistent=False)

    def reset_parameters(self, gen):
        xavier_uniform_(self.relation_att, gen)
        xavier_uniform_(self.relation_msg, gen)
        normal_(self.rel_pos_bias, 0.02, gen)

    def _project(self, layer, x, mode, static_modes=None):
        """A q / k / v projection."""
        return layer(x, mode, static_modes)

    def _typed_kv(self, x, mode, static_modes, taus_used):
        """(B, TAU, L, H, W, 2C) = per receiver-type variant, each sender's
        relation-transformed [K | V], accumulated in float32 (C: this
        rank's heads' channels)."""
        b, l, h, w, c = x.shape
        d = self.dim_head
        heads = self.dim // d
        co = heads * d
        rel_att, rel_msg = self.relation_att, self.relation_msg
        cdt = self.compute_dtype
        f32 = torch.float32
        ty_n = self.num_types
        ntau = len(taus_used)
        if static_modes is not None:
            # fold W_kv[ty] @ blockdiag_heads(R[tau*T+ty]) at the parameter
            # level and emit the [K|V] variants with one contraction
            wk, bk = self.to_k(x, mode, return_params=True)
            wv, bv = self.to_v(x, mode, return_params=True)
            ra, rm = (torch.stack([r.reshape(ty_n, ty_n, heads, d, d)[t]
                                   for t in taus_used])
                      for r in (rel_att, rel_msg))
            ck = torch.einsum("yche,tyhDe->tychD",
                              wk.reshape(ty_n, c, heads, d), ra)
            cv = torch.einsum("yche,tyhDe->tychD",
                              wv.reshape(ty_n, c, heads, d), rm)
            wkv = torch.cat([ck.reshape(ntau, ty_n, c, co),
                             cv.reshape(ntau, ty_n, c, co)], dim=-1)
            cbk = torch.einsum("yhe,tyhDe->tyhD",
                               bk.reshape(ty_n, heads, d), ra)
            cbv = torch.einsum("yhe,tyhDe->tyhD",
                               bv.reshape(ty_n, heads, d), rm)
            bkv = torch.cat([cbk.reshape(ntau, ty_n, co),
                             cbv.reshape(ntau, ty_n, co)], dim=-1)
            # stacked slices, not a list index (which copies the index to
            # the device on every call)
            wsel = torch.stack([wkv[:, int(m)] for m in static_modes],
                               dim=1).to(cdt)   # (ntau, L, C, 2C)
            bsel = torch.stack([bkv[:, int(m)] for m in static_modes],
                               dim=1).to(cdt)   # (ntau, L, 2C)
            # bias joins in fp32 before the compute-dtype rounding
            bias = bsel[None, :, :, None, None].to(f32)
            if not (x.is_cuda and cdt != f32):
                kv2 = torch.einsum("bjxyc,tjcf->btjxyf", x.to(f32),
                                   wsel.to(f32)) + bias
                return kv2.to(cdt)
            # the compute-dtype operands into a float32 product, one GEMM
            # per sender over every variant's columns
            prod = dot_f32(x.transpose(0, 1).reshape(l, b * h * w, c),
                           wsel.permute(1, 2, 0, 3).reshape(l, c, -1))
            prod = prod.view(l, b, h, w, ntau, 2 * co).permute(1, 4, 0, 2,
                                                                3, 5)
            return (prod + bias).to(cdt,
                                    memory_format=torch.contiguous_format)
        k = self._project(self.to_k, x, mode)
        v = self._project(self.to_v, x, mode)
        taus = device_constant(tuple(taus_used), torch.long, x.device)
        idx = taus[:, None, None] * ty_n + mode.long()[None]
        rel = torch.stack([rel_att, rel_msg], dim=1)
        w_t = rel.to(cdt)[idx]  # (TAU, B, J, 2, heads, d, d)
        kvh = torch.stack([k, v], dim=-2).reshape(b, l, h, w, 2, heads, d)
        if not (x.is_cuda and cdt != f32):
            kv2 = torch.einsum("bjxyshe,tbjshde->btjxyshd", kvh.to(f32),
                               w_t.to(f32)).to(cdt)
            return kv2.reshape(b, ntau, l, h, w, 2 * co)
        # the compute-dtype operands into a float32 product: a GEMM per
        # (batch, sender, K / V, head) over every variant's columns
        prod = dot_f32(
            kvh.permute(0, 1, 4, 5, 2, 3, 6).reshape(-1, h * w, d),
            w_t.permute(1, 2, 3, 4, 6, 0, 5).reshape(-1, d, ntau * d))
        prod = prod.view(b, l, 2, heads, h, w, ntau, d).permute(
            0, 6, 1, 4, 5, 2, 3, 7)
        return prod.to(cdt, memory_format=torch.contiguous_format).reshape(
            b, ntau, l, h, w, 2 * co)

    def _variants(self, mode, static_modes, r: int):
        """(receiver types folded, each agent's variant index): with a
        static layout only the types of the first r receivers (one
        variant for the ego-only last phase)."""
        if static_modes is None:
            return tuple(range(self.num_types)), mode
        taus_used = tuple(sorted({int(m) for m in static_modes[:r]}))
        return taus_used, device_constant(
            tuple(taus_used.index(int(m)) if int(m) in taus_used else 0
                  for m in static_modes), torch.long,
            mode.device)[None].expand(mode.shape)

    def _mask_ij(self, pair_mask, r: int):
        """(B, I, J, H, W) mask of each receiver's senders (its own map
        masked out with ``exclude_self``)."""
        l = pair_mask.shape[1]
        mask_ij = pair_mask[:, :r].movedim(-1, 2)
        if self.exclude_self:
            eye = torch.eye(l, device=pair_mask.device)[:r][
                None, :, :, None, None]
            mask_ij = mask_ij * (1.0 - eye)
        return mask_ij

    def _bias_h(self, cdt):
        """(heads, T, T) relative-position bias."""
        return self.rel_pos_bias[self.rel_index].permute(2, 0, 1).to(cdt)

    def forward(self, x, mode, pairwise, agent_mask, pair_mask=None,
                receivers: int | None = None,
                static_modes: tuple | None = None, warp_coef=None):
        b, l, h, w, _ = x.shape
        r = l if receivers is None else receivers
        d, win = self.dim_head, self.window
        heads = self.dim // d
        c = heads * d
        scale = d ** -0.5
        cdt = self.compute_dtype
        x = x.to(cdt)
        sm_r = static_modes[:r] if static_modes is not None else None

        q = self._project(self.to_q, x[:, :r], mode[:, :r], sm_r)
        taus_used, recv_variant = self._variants(mode, static_modes, r)
        kv2 = self._typed_kv(x, mode, static_modes, taus_used)

        if pair_mask is None:
            pair_mask = pairwise_roi_mask(pairwise, agent_mask, (h, w),
                                          self.discrete_ratio,
                                          self.downsample_rate)
        mask_ij = self._mask_ij(pair_mask, r)
        bias_h = self._bias_h(cdt)
        qs = (q * scale).to(cdt)
        local = self.style == "local"

        # sender j's [K|V] in receiver i's variant, warped into i's frame
        if self.use_pallas:
            kv_pair = fused_pair_warp(kv2, pairwise, recv_variant,
                                      self.discrete_ratio,
                                      self.downsample_rate, receivers,
                                      warp_coef)
        else:
            bidx = torch.arange(b, device=x.device)[:, None]
            kv_typed = kv2[bidx, recv_variant[:, :r].long()]
            warp_fn = warp_bev_mxu if self.use_mxu_warp else warp_bev_nhwc
            kv_pair = warp_fn(
                kv_typed.reshape(b * r, l, h, w, 2 * c),
                pairwise.transpose(1, 2)[:, :r].reshape(b * r, l, 4, 4),
                self.discrete_ratio, self.downsample_rate,
            ).reshape(b, r, l, h, w, 2 * c)

        if (self.use_stripe and self.use_pallas and local
                and h % win == 0 and w % win == 0):
            out = fused_stripe_window_attention(
                qs.reshape(b * r, h, w, c),
                kv_pair.reshape(b * r, l, h, w, 2 * c), bias_h,
                mask_ij.reshape(b * r, l, h, w).to(cdt), win, heads, d,
            ).reshape(b, r, h, w, c)
        else:
            qw = _window_split(qs, win, self.style)       # (B, I, X, Y, T, C)
            kvw = _window_split(kv_pair, win, self.style)
            mw = _window_split(mask_ij[..., None], win, self.style)[..., 0]
            nx, ny, t_tok = qw.shape[2], qw.shape[3], win * win
            qw = qw.reshape(b * r, nx * ny, t_tok, c)
            kvw = kvw.reshape(b * r, l, nx * ny, t_tok, 2 * c)
            mw = mw.reshape(b * r, l, nx * ny, t_tok).to(cdt)
            if self.use_pallas:
                out = fused_plain_window_attention(qw, kvw, bias_h, mw,
                                                   heads, d)
            else:
                out = plain_window_attention_xla(
                    qw, kvw[..., :c], kvw[..., c:], bias_h, mw, heads, d)
            out = _window_merge(out.reshape(b, r, nx, ny, t_tok, c), win,
                                self.style, h, w)
        out = self.to_out(out, mode[:, :r], sm_r)
        return self.Dropout_0(out.to(torch.float32))


class SplitAttn(nn.Module):
    """ResNeSt-style radix softmax over parallel branches: the branches'
    sum, averaged over the map, goes through a bias-less fc1, a
    LayerNorm (eps 1e-5), ReLU and a bias-less fc2 to one logit per
    branch and channel; the branches are mixed by the softmax over the
    branch axis."""

    def __init__(self, input_dim: int, branches: int = 2):
        super().__init__()
        self.input_dim = input_dim
        self.fc1 = Dense(input_dim, input_dim, use_bias=False)
        self.bn1 = LayerNorm(input_dim, eps=1e-5)
        self.fc2 = Dense(input_dim, branches * input_dim, use_bias=False)

    def forward(self, branches):
        """branches: list of (B, L, H, W, C)."""
        n = len(branches)
        stacked = torch.stack(branches, dim=-2)  # (B, L, H, W, N, C)
        gap = sum(branches).mean(dim=(2, 3), keepdim=True)
        hidden = torch.relu(self.bn1(self.fc1(gap)))
        logits = self.fc2(hidden)
        logits = logits.reshape(*logits.shape[:-1], n, self.input_dim)
        return (stacked * torch.softmax(logits, dim=-2)).sum(dim=-2)


class HeteroFusionBlock(nn.Module):
    """One H3GAT iteration: local-window then global-grid hetero
    attention, each followed by a hetero feed-forward (sequential mode),
    or both on the same input, mixed by :class:`SplitAttn` (parallel
    mode).  ``dropout`` applies to each attention's message and inside
    each feed-forward in train mode."""

    def __init__(self, input_dim: int, mlp_dim: int, window_size: int = 8,
                 dim_head: int = 32, dropout: float = 0.0,
                 architect_mode: str = "sequential",
                 discrete_ratio: float = 0.4, downsample_rate: float = 4.0,
                 compute_dtype: str = "float32", use_pallas: bool = True,
                 use_stripe: bool = True):
        super().__init__()
        if architect_mode not in ("sequential", "parallel"):
            raise ValueError(f"unknown architect_mode {architect_mode!r}")
        self.architect_mode = architect_mode
        self.discrete_ratio = discrete_ratio
        self.downsample_rate = downsample_rate
        self.compute_dtype = DTYPES[compute_dtype]
        for name, style in (("window", "local"), ("grid", "grid")):
            self.add_module(f"{name}_norm", HeteroLayerNorm(input_dim))
            self.add_module(f"{name}_attn", HeteroWindowAttention(
                input_dim, dim_head, window_size, style,
                discrete_ratio=discrete_ratio,
                downsample_rate=downsample_rate,
                compute_dtype=compute_dtype, use_pallas=use_pallas,
                use_stripe=use_stripe, dropout=dropout))
            self.add_module(f"{name}_ffn_norm", HeteroLayerNorm(input_dim))
            self.add_module(f"{name}_ffn", HeteroFeedForward(
                input_dim, mlp_dim, dropout=dropout))
        if architect_mode == "parallel":
            self.SplitAttn_0 = SplitAttn(input_dim)

    def _phase(self, name, x, mode, pairwise, agent_mask, pair_mask,
               receivers=None, static_modes=None, warp_coef=None):
        r = x.shape[1] if receivers is None else receivers
        sm_r = static_modes[:r] if static_modes is not None else None
        x_n = getattr(self, f"{name}_norm")(x, mode)
        msg = getattr(self, f"{name}_attn")(
            x_n, mode, pairwise, agent_mask, pair_mask, receivers,
            static_modes, warp_coef)
        msg = msg * agent_mask[:, :r, None, None, None]
        x = x[:, :r] + msg
        ffn_in = getattr(self, f"{name}_ffn_norm")(x, mode[:, :r])
        ffn = getattr(self, f"{name}_ffn")(ffn_in.to(self.compute_dtype),
                                           mode[:, :r], sm_r)
        return x + ffn.to(torch.float32)

    def forward(self, x, mode, pairwise, agent_mask, pair_mask=None,
                receivers: int | None = None,
                static_modes: tuple | None = None, warp_coef=None):
        """receivers restricts the block OUTPUT to the first I agents.
        In sequential mode the local phase stays full (the grid phase
        reads every agent's post-local features) and only the grid phase
        is restricted; in parallel mode both phases are.
        pair_mask and warp_coef are the frame's pose-only geometry;
        without them the block builds the mask and each warp its own
        coefficients."""
        if pair_mask is None:
            pair_mask = pairwise_roi_mask(pairwise, agent_mask, x.shape[2:4],
                                          self.discrete_ratio,
                                          self.downsample_rate)
        if self.architect_mode == "parallel":
            return self.SplitAttn_0([
                self._phase(name, x, mode, pairwise, agent_mask, pair_mask,
                            receivers, static_modes, warp_coef)
                for name in ("window", "grid")])
        x = self._phase("window", x, mode, pairwise, agent_mask, pair_mask,
                        static_modes=static_modes, warp_coef=warp_coef)
        return self._phase("grid", x, mode, pairwise, agent_mask, pair_mask,
                           receivers, static_modes, warp_coef)


class HeteroFusion(nn.Module):
    """num_iters x one shared HeteroFusionBlock, then the ego (slot 0)
    map through a modality-typed MLP head.  The last iteration computes
    only the ego receiver."""

    def __init__(self, config: dict):
        super().__init__()
        cfg = config
        blk = cfg["hetero_fusion_block"]
        st = blk.get("spatial_transform", cfg.get("spatial_transform", {}))
        self.discrete_ratio = st.get("voxel_size", [0.4])[0]
        self.downsample_rate = st.get("downsample_rate", 4)
        self.num_iters = cfg["num_iters"]
        self.ego_only_last = cfg.get("ego_only_last", True)
        self.HeteroFusionBlock_0 = HeteroFusionBlock(
            input_dim=blk["input_dim"], mlp_dim=blk["mlp_dim"],
            window_size=blk["window_size"], dim_head=blk["dim_head"],
            dropout=blk.get("drop_out", 0.0),
            architect_mode=blk.get("architect_mode", "sequential"),
            discrete_ratio=self.discrete_ratio,
            downsample_rate=self.downsample_rate,
            compute_dtype=blk.get("compute_dtype", "float32"),
            use_pallas=blk.get("use_pallas", True),
            use_stripe=blk.get("use_stripe", True))
        if blk.get("use_fused_wa"):
            raise ValueError("the reference has no fused warp + attention")
        self.use_pallas = blk.get("use_pallas", True)
        self.mlp_head = HeteroFeedForward(blk["input_dim"], blk["input_dim"])

    def forward(self, x, mode, pairwise, agent_mask,
                static_modes: tuple | None = None):
        hw = tuple(x.shape[2:4])
        pair_mask = pairwise_roi_mask(pairwise, agent_mask, hw,
                                      self.discrete_ratio,
                                      self.downsample_rate)
        # the pair-warp kernel's geometry, shared by every warp of the frame
        warp_coef = (pair_warp_coefficients(pairwise, hw,
                                            self.discrete_ratio,
                                            self.downsample_rate)
                     if self.use_pallas and use_kernel(x) else None)
        for it in range(self.num_iters):
            last = it == self.num_iters - 1
            x = self.HeteroFusionBlock_0(
                x, mode, pairwise, agent_mask, pair_mask,
                receivers=1 if (last and self.ego_only_last) else None,
                static_modes=static_modes, warp_coef=warp_coef)
        ego = self.mlp_head(x[:, :1], mode[:, :1],
                            static_modes[:1] if static_modes is not None
                            else None)
        return ego[:, 0]
