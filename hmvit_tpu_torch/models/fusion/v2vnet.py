"""V2VNet: graph message passing with a ConvGRU state update (port of
``hmvit_tpu/models/fusion/v2vnet.py``), on the (B, I, J) pair axis:

* message = msg_conv([warp_i(state_j), state_i]) * the pair's ROI and
  agent mask, no activation;
* the messages are averaged over the number of real agents (not over
  the valid pixels);
* the ConvGRU runs one step from a zero hidden state with
  [state_i, average] as its input;
* the ego's state goes through a per-pixel Dense.
"""
from __future__ import annotations

import torch
from torch import nn

from ...nn import Conv, Dense
from ...ops.warp import roi_and_agent_mask, warp_bev_nhwc


class ConvGRUStep(nn.Module):
    """One ConvGRU cell step: gates = conv([x, h]) split into (reset,
    update), candidate = tanh(conv([x, reset h])), h' = (1 - update) h +
    update candidate."""

    def __init__(self, cin: int, hidden: int, kernel: int = 3):
        super().__init__()
        self.hidden = hidden
        self.conv_gates = Conv(cin + hidden, 2 * hidden, kernel)
        self.conv_can = Conv(cin + hidden, hidden, kernel)

    def forward(self, x, h):
        """x (..., H, W, Cx), h (..., H, W, hidden)."""
        gates = self.conv_gates(torch.cat([x, h], dim=-1))
        reset = torch.sigmoid(gates[..., :self.hidden])
        update = torch.sigmoid(gates[..., self.hidden:])
        cand = torch.tanh(self.conv_can(torch.cat([x, reset * h], dim=-1)))
        return (1 - update) * h + update * cand


class V2VNetFusion(nn.Module):
    """The JAX module's ``agg_operator="avg"`` and ``gru_flag=True``, the
    only ones any caller builds."""

    def __init__(self, dim: int, num_rounds: int = 2,
                 discrete_ratio: float = 0.4, downsample_rate: float = 4.0):
        super().__init__()
        self.dim, self.num_rounds = dim, num_rounds
        self.discrete_ratio, self.downsample_rate = (discrete_ratio,
                                                     downsample_rate)
        self.msg_conv = Conv(2 * dim, dim, 3)
        self.conv_gru = ConvGRUStep(2 * dim, dim)
        self.out_mlp = Dense(dim, dim)

    def forward(self, x, mode, pairwise, agent_mask):
        b, l, h, w, c = x.shape
        geo = (self.discrete_ratio, self.downsample_rate)
        t_ij = pairwise.transpose(1, 2)  # (B, I, J, 4, 4): j -> i
        com = roi_and_agent_mask(
            b * l, l, h, w, agent_mask[:, None].expand(b, l, l).reshape(-1, l),
            t_ij.reshape(-1, l, 4, 4), *geo).reshape(b, l, h, w, l)
        pair_mask = com.movedim(-1, 2)  # (B, I, J, H, W)
        n_real = torch.clamp(agent_mask.sum(dim=1), min=1.0)
        shape = (b, l, l, h, w, c)
        state = x
        for _ in range(self.num_rounds):
            rep = state[:, None].expand(shape)
            warped = warp_bev_nhwc(rep.reshape(b * l, l, h, w, c),
                                   t_ij.reshape(b * l, l, 4, 4),
                                   *geo).reshape(shape)
            recv = state[:, :, None].expand(shape)
            pair = torch.cat([warped, recv], dim=-1)
            msg = self.msg_conv(pair.reshape(b * l * l, h, w, 2 * c))
            msg = msg.reshape(b, l, l, h, w, self.dim) * pair_mask[..., None]
            agg = msg.sum(dim=2) / n_real[:, None, None, None, None]
            gru_in = torch.cat([state, agg], dim=-1)
            state = self.conv_gru(
                gru_in.reshape(b * l, h, w, 2 * c),
                torch.zeros((b * l, h, w, self.dim), dtype=state.dtype,
                            device=state.device),
            ).reshape(b, l, h, w, self.dim)
            state = state * agent_mask[:, :, None, None, None]
        return self.out_mlp(state[:, 0])
