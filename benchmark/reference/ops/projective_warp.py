"""Dense separable PROJECTIVE (homography) warp (port of
``hmvit_tpu/ops/projective_warp.py``): the BEVFormer planar lift samples
every BEV query's projection into every camera, per height plane, as two
banded-matrix contractions instead of per-query gathers.

  pass 1 (rows):  tmp(y', u)  = sum_v S1[u](y', v)  src(v, u)
  pass 2 (cols):  out(y', x') = sum_u S2[y'](x', u) tmp(y', u)

Both factorization orders run; each destination pixel takes the better
conditioned one.  Pixels behind the camera and off-image taps are zero.
"""
from __future__ import annotations

import torch


def _hat_matrix(coords, size: int, dtype):
    """coords (..., K) -> (..., K, size) bilinear hat weights over cells
    [0, size); non-finite coords contribute zero."""
    coords = torch.nan_to_num(coords, nan=-1e9, posinf=1e9, neginf=-1e9)
    cells = torch.arange(size, dtype=torch.float32, device=coords.device)
    w = torch.clamp(1.0 - torch.abs(coords[..., None] - cells), min=0.0)
    return w.to(dtype)


def _bc(a):
    return a[:, None, None]


def _safe(a, eps=1e-6):
    return torch.where(torch.abs(a) < eps, torch.full_like(a, eps), a)


def _projective_matrices(h, ssize, dsize, dtype):
    """The two banded interpolation matrices: s1 (N, U, Y', V) and
    s2 (N, Y', X', U)."""
    rdim, cdim = ssize
    hd, wd = dsize
    dev = h.device
    h00, h01, h02 = h[:, 0, 0], h[:, 0, 1], h[:, 0, 2]
    h10, h11, h12 = h[:, 1, 0], h[:, 1, 1], h[:, 1, 2]
    h20, h21, h22 = h[:, 2, 0], h[:, 2, 1], h[:, 2, 2]
    f32 = torch.float32
    ys = torch.arange(hd, dtype=f32, device=dev)
    xs = torch.arange(wd, dtype=f32, device=dev)
    us = torch.arange(cdim, dtype=f32, device=dev)

    denom_x = _bc(h00) - us[None, None, :] * _bc(h20)
    safe_dx = torch.where(torch.abs(denom_x) < 1e-6,
                          torch.where(denom_x < 0,
                                      torch.full_like(denom_x, -1e-6),
                                      torch.full_like(denom_x, 1e-6)),
                          denom_x)
    num_x = (us[None, None, :] * (_bc(h21) * ys[None, :, None] + _bc(h22))
             - _bc(h01) * ys[None, :, None] - _bc(h02))
    xprime = num_x / safe_dx
    wproj = _bc(h20) * xprime + _bc(h21) * ys[None, :, None] + _bc(h22)
    vcoord = (_bc(h10) * xprime + _bc(h11) * ys[None, :, None]
              + _bc(h12)) / _safe(wproj)
    vcoord = torch.where(wproj > 1e-6, vcoord, torch.full_like(vcoord, -1e9))
    s1 = _hat_matrix(vcoord.transpose(1, 2), rdim, dtype)

    w2 = (_bc(h20) * xs[None, None, :] + _bc(h21) * ys[None, :, None]
          + _bc(h22))
    ucoord = (_bc(h00) * xs[None, None, :] + _bc(h01) * ys[None, :, None]
              + _bc(h02)) / _safe(w2)
    ucoord = torch.where(w2 > 1e-6, ucoord, torch.full_like(ucoord, -1e9))
    s2 = _hat_matrix(ucoord, cdim, dtype)
    return s1, s2


def _projective_passes_rep(src_in, h, dsize, dtype, rep):
    """Pass 1 for ``rep`` hypotheses per source map (src_in (N, V, U, C),
    h (N*rep, 3, 3)); returns tmp (N*rep, Y', U, C) and s2."""
    n = src_in.shape[0]
    rdim, cdim = src_in.shape[1:3]
    hd = dsize[0]
    s1, s2 = _projective_matrices(h, (rdim, cdim), dsize, dtype)
    f32 = torch.float32
    tmp = torch.einsum("nruyv,nvuc->nryuc",
                       s1.reshape(n, rep, *s1.shape[1:]).to(f32),
                       src_in.to(f32)).to(dtype)
    return tmp.reshape(n * rep, hd, cdim, -1), s2


def _order_pick(h, dsize):
    """True where factorization order A (row-major) is at least as well
    conditioned.  h (N, 3, 3) -> (N, Hd, Wd) bool."""
    hd, wd = dsize
    f32 = torch.float32
    ys = torch.arange(hd, dtype=f32, device=h.device)[None, :, None]
    xs = torch.arange(wd, dtype=f32, device=h.device)[None, None, :]
    w = _bc(h[:, 2, 0]) * xs + _bc(h[:, 2, 1]) * ys + _bc(h[:, 2, 2])
    safe_w = _safe(w)
    u = (_bc(h[:, 0, 0]) * xs + _bc(h[:, 0, 1]) * ys
         + _bc(h[:, 0, 2])) / safe_w
    v = (_bc(h[:, 1, 0]) * xs + _bc(h[:, 1, 1]) * ys
         + _bc(h[:, 1, 2])) / safe_w
    q_a = torch.abs(_bc(h[:, 0, 0]) - u * _bc(h[:, 2, 0]))
    q_b = torch.abs(_bc(h[:, 1, 0]) - v * _bc(h[:, 2, 0]))
    return q_a >= q_b


def projective_reduce_prepare(src, h33, dsize):
    """Weight-independent half of the fused hypothesis reduction:
    pass-1 contractions, pass-2 matrices and the order pick for both
    factorizations.  src (N, Ks, Hs, Ws, C); h33 (N, K, 3, 3), each
    source map serving K // Ks consecutive hypotheses."""
    n, ks, hs, ws, c = src.shape
    k = h33.shape[1]
    rep = k // ks
    hd, wd = dsize
    if hs != ws or k % ks:
        raise ValueError("projective warp needs square maps and K % Ks == 0")
    dtype = src.dtype
    hf = h33.reshape(n * k, 3, 3).to(torch.float32)
    h_sw = torch.stack([hf[:, 1], hf[:, 0], hf[:, 2]], dim=1)
    srcf = src.reshape(n * ks, hs, ws, c)
    tmp_a, s2_a = _projective_passes_rep(srcf, hf, dsize, dtype, rep)
    tmp_b, s2_b = _projective_passes_rep(srcf.transpose(1, 2), h_sw, dsize,
                                         dtype, rep)
    pick_a = _order_pick(hf, dsize).reshape(n, k, hd, wd)
    u_cnt = s2_a.shape[-1]
    return {
        "tmp_a": tmp_a.reshape(n, k, hd, u_cnt, c),
        "tmp_b": tmp_b.reshape(n, k, hd, u_cnt, c),
        "s2_a": s2_a.reshape(n, k, hd, wd, u_cnt),
        "s2_b": s2_b.reshape(n, k, hd, wd, u_cnt),
        "pick_a": pick_a,
        "dtype": dtype,
    }


def projective_reduce_apply(state, weights):
    """out[n] = sum_k weights[n, k] * warp_k: the per-pixel weights and
    the order pick fold into the pass-2 matrices, then contract."""
    dtype = state["dtype"]
    f32 = torch.float32
    wgt = weights.to(f32)
    pick = state["pick_a"].to(f32)
    w_a = (wgt * pick).to(dtype)[..., None]
    w_b = (wgt * (1.0 - pick)).to(dtype)[..., None]
    s2_a = (state["s2_a"] * w_a).to(f32)
    s2_b = (state["s2_b"] * w_b).to(f32)
    out = (torch.einsum("nkyxu,nkyuc->nyxc", s2_a, state["tmp_a"].to(f32))
           + torch.einsum("nkyxu,nkyuc->nyxc", s2_b, state["tmp_b"].to(f32)))
    return out.to(dtype)
