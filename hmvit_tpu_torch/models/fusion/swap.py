"""Swap attention and the SwapFusion encoder (port of
``hmvit_tpu/models/fusion/swap.py``): masked joint attention over every
agent's tokens inside each local window or global grid cell, with a
three-axis (agent, h, w) relative position bias, and the CoBEVT fusion
built on it.  Plain PyTorch (einsums, as in the JAX package)."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...nn import Dense, LayerNorm, normal_
from ...ops.warp import roi_and_agent_mask, warp_bev_nhwc
from ..hetero_fusion import _window_merge, _window_split


def relative_position_index_3d(agents: int, win: int) -> np.ndarray:
    """(agents win^2, agents win^2) index into the (2 agents - 1)
    (2 win - 1)^2 relative-bias table, token order (agent, w1, w2)."""
    coords = np.stack(
        np.meshgrid(np.arange(agents), np.arange(win), np.arange(win),
                    indexing="ij")
    ).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += agents - 1
    rel[:, :, 1] += win - 1
    rel[:, :, 2] += win - 1
    rel[:, :, 0] *= (2 * win - 1) * (2 * win - 1)
    rel[:, :, 1] *= 2 * win - 1
    return rel.sum(-1)


class SwapAttention(nn.Module):
    """Joint attention over all agents' tokens inside each window
    (``style`` "local") or grid cell ("grid"): tokens agent-major, scores
    and weighted sum in float32, keys of masked-out cells at -1e9."""

    def __init__(self, dim: int, dim_head: int = 32, window: int = 8,
                 agent_size: int = 5, style: str = "local"):
        super().__init__()
        self.dim, self.dim_head, self.window = dim, dim_head, window
        self.style = style
        self.heads = dim // dim_head
        self.to_qkv = Dense(dim, 3 * dim, use_bias=False)
        self.to_out = Dense(dim, dim, use_bias=False)
        self.rel_pos_bias = nn.Parameter(torch.empty(
            (2 * agent_size - 1) * (2 * window - 1) ** 2, self.heads))
        self.register_buffer(
            "rel_index",
            torch.as_tensor(relative_position_index_3d(agent_size, window),
                            dtype=torch.long),
            persistent=False)

    def reset_parameters(self, gen):
        normal_(self.rel_pos_bias, 0.02, gen)

    def forward(self, x, mask):
        """x (B, L, H, W, C), mask (B, L, H, W) validity -> (B, L, H, W,
        C); L at most ``agent_size``."""
        b, l, h, w, c = x.shape
        heads, d, win = self.heads, self.dim_head, self.window
        q, k, v = torch.split(self.to_qkv(x), c, dim=-1)

        def wsplit(t):
            return _window_split(t, win, self.style)

        nx, ny = h // win, w // win
        t_tok = win * win

        def tokens(t):
            # (B, L, X, Y, T, C) -> (B, X, Y, L T, heads, d), agent-major
            t = wsplit(t).permute(0, 2, 3, 1, 4, 5)
            return t.reshape(b, nx, ny, l * t_tok, heads, d)

        f32 = torch.float32
        qh = tokens(q) * d ** -0.5
        sim = torch.einsum("bxyihd,bxyjhd->bxyhij", qh.to(f32),
                           tokens(k).to(f32))
        # agent-major order: the leading l t rows and columns of the
        # agent_size table's index are the l-agent block
        n_tok = l * t_tok
        idx = self.rel_index[:n_tok, :n_tok]
        sim = sim + self.rel_pos_bias[idx].permute(2, 0, 1)
        key_mask = wsplit(mask[..., None])[..., 0].permute(0, 2, 3, 1, 4)
        key_mask = key_mask.reshape(b, nx, ny, 1, 1, n_tok)
        sim = torch.where(key_mask > 0, sim,
                          torch.full((), -1e9, dtype=sim.dtype,
                                     device=sim.device))
        attn = torch.softmax(sim, dim=-1)
        out = torch.einsum("bxyhij,bxyjhd->bxyihd", attn,
                           tokens(v).to(f32))
        out = out.reshape(b, nx, ny, l, t_tok, heads * d)
        out = out.permute(0, 3, 1, 2, 4, 5)  # (B, L, X, Y, T, C)
        return self.to_out(_window_merge(out, win, self.style, h, w))


class SwapFusionEncoder(nn.Module):
    """Every agent warped into the ego frame, then ``depth`` x [local
    window attention, FFN, grid attention, FFN], each a pre-norm residual
    (``fn(LN(x)) + x``; the FFN's GELU the erf form), and the head: the
    mean over the live agents, LayerNorm, Dense.  The relative-bias table
    is sized for ``agent_size`` agents (the JAX module sizes it for
    max(agent_size, L) when it is initialised): a fleet of more slots
    raises."""

    def __init__(self, dim: int, depth: int = 1, window: int = 8,
                 dim_head: int = 32, agent_size: int = 5,
                 discrete_ratio: float = 0.4, downsample_rate: float = 4.0):
        super().__init__()
        self.depth, self.agent_size = depth, agent_size
        self.discrete_ratio, self.downsample_rate = (discrete_ratio,
                                                     downsample_rate)
        mlp_dim = 2 * dim
        for di in range(depth):
            for style in ("local", "grid"):
                p = f"{style}_{di}"
                self.add_module(f"attn_{p}", SwapAttention(
                    dim, dim_head, window, agent_size=agent_size,
                    style=style))
                self.add_module(f"attn_norm_{p}", LayerNorm(dim))
                self.add_module(f"ff_norm_{p}", LayerNorm(dim))
                self.add_module(f"ff_in_{p}", Dense(dim, mlp_dim))
                self.add_module(f"ff_out_{p}", Dense(mlp_dim, dim))
        self.head_norm = LayerNorm(dim)
        self.head_linear = Dense(dim, dim)

    def forward(self, x, mode, pairwise, agent_mask):
        b, l, h, w, c = x.shape
        if l > self.agent_size:
            raise ValueError(f"SwapFusionEncoder: {l} agent slots, but the "
                             f"relative-bias table is built for "
                             f"agent_size={self.agent_size}")
        t = pairwise[:, :, 0]  # j -> ego
        geo = (self.discrete_ratio, self.downsample_rate)
        x = warp_bev_nhwc(x, t, *geo)
        mask = roi_and_agent_mask(b, l, h, w, agent_mask, t, *geo)
        mask = mask[..., 0, :].movedim(-1, 1)  # (B, L, H, W)
        for di in range(self.depth):
            for style in ("local", "grid"):
                p = f"{style}_{di}"
                x = x + getattr(self, f"attn_{p}")(
                    getattr(self, f"attn_norm_{p}")(x), mask)
                ff = getattr(self, f"ff_in_{p}")(
                    getattr(self, f"ff_norm_{p}")(x))
                x = x + getattr(self, f"ff_out_{p}")(F.gelu(ff))
        valid = agent_mask[:, :, None, None, None]
        fused = (x * valid).sum(dim=1) / torch.clamp(valid.sum(dim=1),
                                                     min=1.0)
        return self.head_linear(self.head_norm(fused))
