"""V2X-ViT fusion (port of ``hmvit_tpu/models/fusion/v2xvit.py``):
every agent warped into the ego frame, then per block (a) HGT attention,
each pixel attending across the agents with relation weights typed by
the (receiver, sender) modality pair, and (b) window self-attention at
several window sizes, mixed by :class:`SplitAttn`.

:class:`WindowSelfAttention` is, on CUDA tensors, the single-sender case
of the plain window attention kernel (one launch a window size: T = 16,
64 and 256 tokens at windows 4, 8 and 16); on CPU tensors the JAX
package's dense einsum path.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn import Dense, LayerNorm, gelu, normal_, xavier_uniform_
from ...ops import use_kernel
from ...ops.warp import roi_and_agent_mask, warp_bev_nhwc
from ...ops.window_attention import fused_plain_window_attention
from ...parallel.collectives import gather_from_model, split_to_model
from ..hetero_fusion import SplitAttn, _window_merge, _window_split, \
    relative_position_index
from ..layers import HeteroDense, HeteroFeedForward, HeteroLayerNorm, \
    hetero_param_gather


class HGTCavAttention(nn.Module):
    """Per-pixel typed attention across the agents (window size 1):
    q W_att[pair] . k over the senders J, masked where the sender's map
    is out of view, softmax over J, and the messages v W_msg[pair]
    summed; the products in float32.  Under tensor parallelism (JAX's
    rules split ``to_q`` / ``to_k`` / ``to_v`` by columns and ``to_out``
    by rows) every rank gathers the projections to whole heads, attends
    on every head and hands ``to_out`` its channels of the message."""

    def __init__(self, dim: int, heads: int = 8, num_types: int = 2):
        super().__init__()
        self.dim, self.heads, self.num_types = dim, heads, num_types
        d = dim // heads
        for name in ("to_q", "to_k", "to_v", "to_out"):
            self.add_module(name, HeteroDense(dim, dim, num_types))
        self.relation_att = nn.Parameter(
            torch.empty(num_types ** 2, heads, d, d))
        self.relation_msg = nn.Parameter(
            torch.empty(num_types ** 2, heads, d, d))

    def reset_parameters(self, gen):
        xavier_uniform_(self.relation_att, gen)
        xavier_uniform_(self.relation_msg, gen)

    def forward(self, x, mode, mask):
        """x (B, L, H, W, C), mode (B, L), mask (B, L, H, W) validity of
        each sender in the ego frame."""
        b, l, h, w, c = x.shape
        heads, d = self.heads, self.dim // self.heads
        f32 = torch.float32

        tp = self.to_q.tp

        def split(z):
            if tp is not None:
                z = gather_from_model(z, -1, tp.group)
            return z.reshape(b, l, h, w, heads, d).to(f32)

        qh = split(self.to_q(x, mode) * d ** -0.5)
        kh, vh = split(self.to_k(x, mode)), split(self.to_v(x, mode))
        pair = mode[:, :, None] * self.num_types + mode[:, None, :]
        w_att = hetero_param_gather(self.relation_att, pair).to(f32)
        w_msg = hetero_param_gather(self.relation_msg, pair).to(f32)
        q_rel = torch.einsum("bihwnd,bijnde->bijhwne", qh, w_att)
        sim = torch.einsum("bijhwne,bjhwne->bijhwn", q_rel, kh)
        sim = torch.where(mask[:, None, :, :, :, None] > 0, sim, -1e9)
        attn = torch.softmax(sim, dim=2)  # over the senders
        v_msg = torch.einsum("bijnde,bjhwne->bijhwnd", w_msg, vh)
        out = torch.einsum("bijhwn,bijhwnd->bihwnd", attn, v_msg)
        out = out.reshape(b, l, h, w, heads * d)
        if tp is not None:
            out = split_to_model(out, -1, tp.group)
        return self.to_out(out, mode)


class WindowSelfAttention(nn.Module):
    """Per-agent window self-attention with a relative position bias."""

    def __init__(self, dim: int, window: int, heads: int = 8):
        super().__init__()
        self.dim, self.window, self.heads = dim, window, heads
        self.Dense_0 = Dense(dim, 3 * dim, use_bias=False)
        self.Dense_1 = Dense(dim, dim)
        self.rel_pos_bias = nn.Parameter(
            torch.empty((2 * window - 1) ** 2, heads))
        self.register_buffer(
            "rel_index",
            torch.as_tensor(relative_position_index(window), dtype=torch.long),
            persistent=False)

    def reset_parameters(self, gen):
        normal_(self.rel_pos_bias, 0.02, gen)

    def forward(self, x):
        """x (B, L, H, W, C) -> (B, L, H, W, C)."""
        b, l, h, w, c = x.shape
        d = self.dim // self.heads
        win = self.window
        qkv = self.Dense_0(x)
        qw = _window_split(qkv[..., :c], win, "local")
        kvw = _window_split(qkv[..., c:], win, "local")
        nx, ny, t = qw.shape[2], qw.shape[3], win * win
        bias_h = self.rel_pos_bias[self.rel_index].permute(2, 0, 1)
        if use_kernel(qw):
            out = fused_plain_window_attention(
                (qw * d ** -0.5).reshape(b * l, nx * ny, t, c),
                kvw.reshape(b * l, 1, nx * ny, t, 2 * c), bias_h,
                torch.ones((b * l, 1, nx * ny, t), dtype=qw.dtype,
                           device=qw.device),
                self.heads, d,
            ).reshape(b, l, nx, ny, t, c)
        else:
            def heads_split(z):
                return z.reshape(b, l, nx, ny, t, self.heads, d)

            f32 = torch.float32
            qh = heads_split(qw) * d ** -0.5
            kh = heads_split(kvw[..., :c])
            vh = heads_split(kvw[..., c:])
            sim = torch.einsum("blxyihd,blxyjhd->blxyhij", qh.to(f32),
                               kh.to(f32))
            sim = sim + bias_h[None, None, None, None]
            attn = torch.softmax(sim, dim=-1)
            out = torch.einsum("blxyhij,blxyjhd->blxyihd", attn, vh.to(f32))
            out = out.reshape(b, l, nx, ny, t, self.heads * d)
        out = _window_merge(out, win, "local", h, w)
        return self.Dense_1(out)


class PyramidWindowAttention(nn.Module):
    """Window self-attentions at several sizes on the same input, mixed
    by :class:`SplitAttn` (one window: its branch alone)."""

    def __init__(self, dim: int, windows=(4, 8, 16), heads: int = 8):
        super().__init__()
        self.branches = []
        for i, win in enumerate(windows):
            branch = WindowSelfAttention(dim, win, heads)
            self.add_module(f"WindowSelfAttention_{i}", branch)
            self.branches.append(branch)
        if len(windows) > 1:
            self.SplitAttn_0 = SplitAttn(dim, len(windows))

    def forward(self, x):
        outs = [branch(x) for branch in self.branches]
        return outs[0] if len(outs) == 1 else self.SplitAttn_0(outs)


class V2XTransformer(nn.Module):
    """The V2X-ViT block stack; returns the fused ego map (B, H, W, C).

    With ``prior_encoding`` the (velocity / 30, time delay, infra)
    context of each agent (B, L, 3) is model input: its channels are
    concatenated to every pixel and projected back (``prior_proj``), the
    delay (in frames, clipped to ``max_delay``) indexes a learned
    relative-temporal embedding added per agent, and infrastructure
    agents are a third HGT node type.  The JAX module builds that branch
    when it is initialised with the context; here ``prior_encoding``
    says at construction whether the forward takes it.  The forward
    runs deterministically (no dropout) in train mode too: no caller of
    the JAX package passes ``deterministic``."""

    # the RTE table's largest delay (frames of 100 ms)
    max_delay = 10

    def __init__(self, dim: int, depth: int = 1, heads: int = 8,
                 windows=(4, 8, 16), discrete_ratio: float = 0.4,
                 downsample_rate: float = 4.0, prior_encoding: bool = False):
        super().__init__()
        self.dim, self.depth = dim, depth
        self.discrete_ratio, self.downsample_rate = (discrete_ratio,
                                                     downsample_rate)
        self.prior = prior_encoding
        types = 3 if prior_encoding else 2
        if prior_encoding:
            self.prior_proj = Dense(dim + 3, dim)
            self.rte_embedding = nn.Parameter(
                torch.empty(self.max_delay + 1, dim))
        for i in range(depth):
            self.add_module(f"HGTCavAttention_{i}",
                            HGTCavAttention(dim, heads, types))
            self.add_module(f"HeteroFeedForward_{i}",
                            HeteroFeedForward(dim, dim, num_types=types))
            self.add_module(f"PyramidWindowAttention_{i}",
                            PyramidWindowAttention(dim, windows, heads))
            for k in (2 * i, 2 * i + 1):
                self.add_module(f"HeteroLayerNorm_{k}",
                                HeteroLayerNorm(dim, types))
                self.add_module(f"LayerNorm_{k}", LayerNorm(dim))
            # flax names the outer Dense of ``Dense(C)(gelu(Dense(2C)(.)))``
            # first
            self.add_module(f"Dense_{2 * i}", Dense(2 * dim, dim))
            self.add_module(f"Dense_{2 * i + 1}", Dense(dim, 2 * dim))

    def reset_parameters(self, gen):
        if self.prior:
            normal_(self.rte_embedding, 0.02, gen)

    def forward(self, x, mode, pairwise, agent_mask, prior_encoding=None,
                spatial_correction=None):
        """x (B, L, H, W, C) per-agent maps in their own frames, mode
        (B, L), pairwise (B, L, L, 4, 4), agent_mask (B, L);
        prior_encoding (B, L, 3), given exactly when the module was built
        for it; spatial_correction (B, L, 4, 4) (delayed ego -> current
        ego, composed into each agent's transform to the ego)."""
        if (prior_encoding is not None) != self.prior:
            raise ValueError(
                f"V2XTransformer built with prior_encoding={self.prior} "
                f"called {'with' if prior_encoding is not None else 'without'}"
                f" it")
        b, l, h, w, c = x.shape
        if self.prior:
            prior = prior_encoding[:, :, None, None, :].expand(
                b, l, h, w, 3).to(x.dtype)
            x = self.prior_proj(torch.cat([x, prior], dim=-1))
            dt = torch.clamp(prior_encoding[:, :, 1].to(torch.int32), 0,
                             self.max_delay)
            x = x + self.rte_embedding[dt.long()][:, :, None, None, :]
            mode = torch.where(prior_encoding[:, :, 2] > 0.5, 2, mode)
        t = pairwise[:, :, 0]
        if spatial_correction is not None:
            t = spatial_correction.to(t.dtype) @ t
        geo = (self.discrete_ratio, self.downsample_rate)
        x = warp_bev_nhwc(x, t, *geo)
        mask = roi_and_agent_mask(b, l, h, w, agent_mask, t, *geo)
        mask = mask[..., 0, :].movedim(-1, 1)  # (B, L, H, W)
        for i in range(self.depth):
            m = getattr(self, f"HGTCavAttention_{i}")
            a = m(getattr(self, f"HeteroLayerNorm_{2 * i}")(x, mode), mode,
                  mask)
            x = x + a * mask[..., None]
            x = x + getattr(self, f"HeteroFeedForward_{i}")(
                getattr(self, f"HeteroLayerNorm_{2 * i + 1}")(x, mode), mode)
            x = x + getattr(self, f"PyramidWindowAttention_{i}")(
                getattr(self, f"LayerNorm_{2 * i}")(x))
            ff = getattr(self, f"Dense_{2 * i + 1}")(
                getattr(self, f"LayerNorm_{2 * i + 1}")(x))
            x = x + getattr(self, f"Dense_{2 * i}")(gelu(ff))
        return x[:, 0]
