"""Per-pair BEV warp of typed sender maps into every receiver's frame
(port of ``hmvit_tpu/ops/fused_warp.py``).

:func:`fused_pair_warp` launches a CUDA kernel of ``csrc/pair_warp.cu``
for CUDA tensors — the tile kernel (the replacement of the Pallas
``_warp_kernel``) or, with ``variant="resident"``, the resident kernel
(the replacement of ``_warp_kernel_resident``; same output bits) — and
runs :func:`pair_warp_xla` — type gather + :func:`warp_bev_mxu`, the
JAX package's oracle — for CPU tensors or under
:func:`hmvit_tpu_torch.ops.plain_ops`.  Its backward recomputes through
the plain twin.

Both kernels and the twin take the Pallas kernels' destination-row
window (``dest_row_start`` / ``dest_row_tiles``: whole 32-row tiles of
the output, the source read whole), which the spatial-partitioning
island of ``models/hetero_fusion.py`` runs a shard's rows by (its
variant is ``auto``, the tile kernel, as in the JAX package).

Both kernels, and the fused warp + attention kernel, skip what is out of
a sender's view, as the Pallas kernels do, but by a conservative test
(:func:`roi_tile_valid` here, ``tile_in_view`` in
``csrc/warp_taps.cuh``): a skipped tile is one the taps would have
filled with zeros, so the skip changes no bit and the twin needs none.
"""
from __future__ import annotations

import torch

from . import cuda, opcount, use_kernel
from ..tracing import twin_backward
from .shear_warp import _affine_coefficients, _pixel_affine, warp_bev_mxu
from .warp import centered_affine, discretize_transform


def pair_warp_coefficients(pairwise, hw, discrete_ratio, downsample_rate):
    """Post-swap affine coefficients of every (receiver i, sender j) pair:
    (B, I=L, J=L, 8) float32.  They depend on the poses only, so a frame
    computes them once and hands them to each of its warps.

    coef rows: [m00, m01, tx, v0, v1, ty_adj, swap, flag] with flag 1 for
    identity pairs (copied, no interpolation), 2 for pairs with non-finite
    coefficients (written as zeros), else 0."""
    b, l = pairwise.shape[:2]
    t_ij = pairwise.transpose(1, 2).reshape(b * l * l, 4, 4)
    m23 = discretize_transform(t_ij, discrete_ratio, downsample_rate)
    t = centered_affine(m23.to(torch.float32), hw)
    a = _pixel_affine(t, hw, hw)
    m00, m01, tx, v0, v1, ty_adj, swap = _affine_coefficients(a)
    ident = ((torch.abs(m00 - 1.0) + torch.abs(m01) + torch.abs(tx)
              + torch.abs(v0) + torch.abs(v1 - 1.0) + torch.abs(ty_adj)
              < 1e-4) & ~swap)
    coef = torch.stack([m00, m01, tx, v0, v1, ty_adj, swap.to(torch.float32),
                        ident.to(torch.float32)], dim=-1)
    bad = ~torch.isfinite(coef).all(dim=-1)
    coef = torch.where(torch.isfinite(coef), coef, torch.zeros_like(coef))
    coef[:, 7] = torch.where(bad, torch.full_like(coef[:, 7], 2.0),
                             coef[:, 7])
    return coef.reshape(b, l, l, 8)


def _prep_affines(pairwise, mode, hw, discrete_ratio, downsample_rate,
                  num_receivers=None, coef=None):
    """The kernel's per-launch tables: (coef (B*I, J, 8) f32, rtype (B*I,)
    i32) for the first I receivers.  ``coef`` is the frame's
    :func:`pair_warp_coefficients`, computed here when not given."""
    b, l = pairwise.shape[:2]
    r = l if num_receivers is None else num_receivers
    if coef is None:
        coef = pair_warp_coefficients(pairwise, hw, discrete_ratio,
                                      downsample_rate)
    rtype = mode[:, :r].to(torch.int32).reshape(b * r)
    return (coef[:, :r].reshape(b * r, l, 8).contiguous(),
            rtype.contiguous())


def rect_in_view(coef, x0, y0, w, h, size: int):
    """Whether any destination pixel of the rectangle [x0, x0 + w) x [y0,
    y0 + h) of a pair reads a source pixel of the size x size map: the
    predicate of ``tile_in_view`` in ``csrc/warp_taps.cuh``, in the same
    float32 operations.  coef (..., 8) coefficient rows
    (:func:`pair_warp_coefficients`); x0, y0, w, h broadcast against
    coef[..., 0].  False for invalid pairs, True for identity pairs.

    Conservative, where the Pallas kernels' test is not: a column tap
    contributes only where the column coordinate lies in (-1, size), a
    row tap only where the row coordinate does, and the row coordinate,
    taken at the integer column tap c with |c - ccoord| < 1, lies within
    |v0| of the affine row v0 m00 x' + (v0 m01 + v1) y' + ty_adj + v0 tx;
    so its margin is 1 + |v0|, not 1.  The slack (1e-3 + 1e-5 of the
    terms' magnitude, some 80 ulps) covers the fp32 rounding of the
    kernels' coordinates and of this test."""
    f32 = torch.float32
    m00, m01, tx, v0, v1, tya = (coef[..., k] for k in range(6))
    flag = coef[..., 7]
    xa = torch.as_tensor(x0, dtype=f32, device=coef.device)
    ya = torch.as_tensor(y0, dtype=f32, device=coef.device)
    xb = xa + (torch.as_tensor(w, dtype=f32, device=coef.device) - 1.0)
    yb = ya + (torch.as_tensor(h, dtype=f32, device=coef.device) - 1.0)

    def span(cx, cy, c0):
        p, q, u, v = cx * xa, cx * xb, cy * ya, cy * yb
        return ((torch.minimum(p, q) + torch.minimum(u, v)) + c0,
                (torch.maximum(p, q) + torch.maximum(u, v)) + c0)

    rx = v0 * m00
    ry = v0 * m01 + v1
    r0 = tya + v0 * tx
    col_lo, col_hi = span(m00, m01, tx)
    row_lo, row_hi = span(rx, ry, r0)
    av0 = v0.abs()
    fsize = float(size)
    mag = (((m00.abs() + m01.abs()) + (v1.abs()
                                       + av0 * ((m00.abs() + m01.abs())
                                                + 1.0)))
           * (fsize + 1.0)
           + ((tx.abs() + tya.abs()) + (v0 * tx).abs()))
    slack = 1e-3 + 1e-5 * mag
    seen = ((col_hi > -(1.0 + slack)) & (col_lo < fsize + slack)
            & (row_hi > -((1.0 + av0) + slack))
            & (row_lo < fsize + (av0 + slack)))
    return torch.where(flag > 1.5, False, torch.where(flag > 0.5, True,
                                                      seen))


def roi_tile_valid(coef, size: int, tile: int = 32):
    """(..., XT, YT) bool: which tile x tile destination tiles (clipped to
    the map; XT = YT = ceil(size / tile)) of each pair are in view —
    the Pallas kernels' ROI tile skip (``_prep_affines``' ``valid``, in
    its (xt, yt) order), made conservative (:func:`rect_in_view`).  A
    tile marked False is exactly zero in the kernels' output and in the
    twin's."""
    n_t = -(-size // tile)
    starts = torch.arange(n_t, device=coef.device) * tile
    x0 = starts[:, None]
    y0 = starts[None, :]
    w = torch.clamp(size - x0, max=tile)
    h = torch.clamp(size - y0, max=tile)
    return rect_in_view(coef[..., None, None, :], x0, y0, w, h, size)


# the unit of a destination-row window: the Pallas kernel's row tile
WINDOW_TILE = 32


def row_window(h: int, dest_row_start=None, dest_row_tiles=None):
    """(first row, rows) of the destination-row window ``[dest_row_start,
    dest_row_start + dest_row_tiles)`` of 32-row tiles on a map of h rows,
    or (0, h) without one.  A window that runs past the map, or one on a
    map whose h is not a multiple of 32, raises ValueError."""
    if dest_row_start is None and dest_row_tiles is None:
        return 0, h
    if dest_row_start is None or dest_row_tiles is None:
        raise ValueError("pair warp: dest_row_start and dest_row_tiles go "
                         "together")
    start, tiles = int(dest_row_start), int(dest_row_tiles)
    if h % WINDOW_TILE or start < 0 or tiles <= 0 \
            or start + tiles > h // WINDOW_TILE:
        raise ValueError(f"pair warp: a window of {tiles} row tiles from "
                         f"tile {start} does not fit a map of {h} rows "
                         f"(whole tiles of {WINDOW_TILE} rows)")
    return start * WINDOW_TILE, tiles * WINDOW_TILE


def pair_warp_xla(src_typed, pairwise, mode, discrete_ratio,
                  downsample_rate, num_receivers=None, dest_row_start=None,
                  dest_row_tiles=None):
    """Plain twin: type gather + separable warp.

    src_typed (B, TY, J, H, W, C); pairwise (B, L, L, 4, 4) with
    pairwise[b, j, i] mapping j's frame into i's; mode (B, L) receiver
    variant.  Returns (B, I, J, H_out, W, C): the whole map, or the rows
    of the destination-row window (:func:`row_window`), sliced from the
    whole warp."""
    bsz, _, l, h, w, ck = src_typed.shape
    row0, rows = row_window(h, dest_row_start, dest_row_tiles)
    r = l if num_receivers is None else num_receivers
    bidx = torch.arange(bsz, device=src_typed.device)[:, None]
    typed = src_typed[bidx, mode[:, :r].long()]  # (B, I, J, H, W, C)
    t_ij = pairwise.transpose(1, 2)[:, :r]
    out = warp_bev_mxu(
        typed.reshape(bsz * r, l, h, w, ck),
        t_ij.reshape(bsz * r, l, 4, 4),
        discrete_ratio, downsample_rate,
    ).reshape(bsz, r, l, h, w, ck)
    return out if rows == h else out[:, :, :, row0:row0 + rows]


# the resident variant's gate, the JAX package's rule on this card: a
# whole map at 8 bytes a pixel fits a block's shared memory (227 KB on
# Hopper).  The kernel stages a map's channel slab (16-64 bytes a pixel)
# in the shared memory of a cluster of 8 blocks, a band of rows each, so
# every map the gate admits fits.
RESIDENT_SLAB_BYTES = 8
MAX_SHARED_BYTES = 232448


def resolve_variant(variant: str, h: int, w: int) -> str:
    """The kernel a requested variant runs on an (h, w) map, by the JAX
    package's rule: ``auto`` is ``tile``; ``resident`` holds only for a
    square map with h >= 64 and h % 32 == 0 that fits on chip (here: a
    block's shared memory), else it falls to ``tile``."""
    if variant not in ("auto", "tile", "resident"):
        raise ValueError(f"unknown pair-warp variant {variant!r}")
    if variant == "resident" and h == w and h >= 64 and h % 32 == 0 \
            and h * w * RESIDENT_SLAB_BYTES <= MAX_SHARED_BYTES:
        return "resident"
    return "tile"


def pair_warp_launch(src_typed, pairwise, mode, discrete_ratio,
                     downsample_rate, num_receivers=None, coef=None,
                     variant: str = "auto", previous: bool = False,
                     dest_row_start=None, dest_row_tiles=None):
    """Validate and lay out one pair-warp launch: returns (launch, out)
    where ``launch()`` runs the kernel into ``out`` (B, I, J, H_out, W,
    C).  ``coef`` is the frame's :func:`pair_warp_coefficients` of
    ``pairwise``, or None to compute them here.  ``previous`` runs the
    tile kernel's previous body whatever the variant: for timing only, it
    gives the same bits.  ``dest_row_start`` / ``dest_row_tiles`` (host
    ints) restrict the output to a destination-row window
    (:func:`row_window`) of either kernel; its launches also count under
    the key "window" (``cuda.PAIR_WARP.launches_by_key``,
    ``cuda.PAIR_WARP_RESIDENT.launches_by_key``)."""
    bsz, ty_count, l, h, w, ck = src_typed.shape
    row0, rows = row_window(h, dest_row_start, dest_row_tiles)
    windowed = dest_row_tiles is not None
    kind = resolve_variant(variant, h, w)
    if windowed and previous:
        raise ValueError("pair warp: the previous body takes no "
                         "destination-row window")
    resident = kind == "resident" and not previous
    kernel = (cuda.PAIR_WARP_PREVIOUS if previous
              else cuda.PAIR_WARP_RESIDENT if resident else cuda.PAIR_WARP)
    r = l if num_receivers is None else num_receivers
    if src_typed.dtype not in cuda.DTYPE_CODES:
        raise TypeError(f"pair warp: unsupported dtype {src_typed.dtype}")
    if h != w or ck % 8 or h * w * ck >= 2 ** 31:
        raise ValueError(f"pair warp needs square maps of fewer than 2^31 "
                         f"elements and C % 8 == 0, got {(h, w, ck)}")
    if (tuple(pairwise.shape) != (bsz, l, l, 4, 4)
            or tuple(mode.shape) != (bsz, l) or not 0 < r <= l):
        raise ValueError(f"pair warp: pairwise {tuple(pairwise.shape)}, "
                         f"mode {tuple(mode.shape)} and {r} receivers do "
                         f"not fit src {tuple(src_typed.shape)}")
    if coef is not None and (tuple(coef.shape) != (bsz, l, l, 8)
                             or coef.dtype != torch.float32):
        raise ValueError(f"pair warp: coefficients {tuple(coef.shape)} "
                         f"{coef.dtype}, want ({bsz}, {l}, {l}, 8) float32")
    coef, rtype = _prep_affines(pairwise, mode, (h, w), discrete_ratio,
                                downsample_rate, r, coef)
    # the kernel reads src[b, rtype[n]]: an out-of-range variant raises
    # (asynchronously, on the device) instead of reading past the map
    torch._assert_async(((rtype >= 0) & (rtype < ty_count)).all(),
                        "pair warp: receiver variant out of range")
    src = src_typed.contiguous()
    out = torch.empty((bsz, r, l, rows, w, ck), dtype=src.dtype,
                      device=src.device)
    ints = [cuda.DTYPE_CODES[src.dtype], bsz * r, l, ty_count, r, h, w, ck,
            row0, rows]
    key = "window" if windowed else None
    return lambda: kernel.launch([src, coef, rtype, out], ints, key), out


class _PairWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src_typed, pairwise, mode, dr, ds, nr, coef, variant,
                start, tiles):
        ctx.save_for_backward(src_typed, pairwise, mode)
        ctx.args = (dr, ds, nr, start, tiles)
        launch, out = pair_warp_launch(src_typed, pairwise, mode, dr, ds, nr,
                                       coef, variant, dest_row_start=start,
                                       dest_row_tiles=tiles)
        launch()
        return out

    @staticmethod
    def backward(ctx, g):
        src, pairwise, mode = ctx.saved_tensors
        with twin_backward("pair_warp"), torch.enable_grad():
            s = src.detach().requires_grad_()
            out = pair_warp_xla(s, pairwise, mode, *ctx.args)
            (gs,) = torch.autograd.grad(out, s, g)
        return gs, None, None, None, None, None, None, None, None, None


def fused_pair_warp(src_typed, pairwise, mode, discrete_ratio,
                    downsample_rate, num_receivers=None, coef=None,
                    variant: str = "auto", dest_row_start=None,
                    dest_row_tiles=None):
    """CUDA kernel forward (plain-twin backward) for CUDA tensors; the
    plain twin for CPU tensors and under ``plain_ops()``.  ``coef``, the
    frame's :func:`pair_warp_coefficients`, spares the kernel path its
    geometry; the plain twin derives its own from ``pairwise``.
    ``variant`` picks the kernel (:func:`resolve_variant`); both give
    the same bits, and the twin is the same for both.
    ``dest_row_start`` / ``dest_row_tiles`` restrict the output to a
    destination-row window (:func:`row_window`; host ints, either
    kernel)."""
    kind = resolve_variant(variant, *src_typed.shape[3:5])
    b, _, j, h, w, c = src_typed.shape
    _, rows = row_window(h, dest_row_start, dest_row_tiles)
    opcount.note("pair_warp_resident" if kind == "resident"
                 else "pair_warp", opcount.pair_warp_ops(
                     b * (j if num_receivers is None else num_receivers), j,
                     rows, w, c))
    if use_kernel(src_typed):
        return _PairWarp.apply(src_typed, pairwise, mode, discrete_ratio,
                               downsample_rate, num_receivers, coef, variant,
                               dest_row_start, dest_row_tiles)
    with opcount.hidden():
        return pair_warp_xla(src_typed, pairwise, mode, discrete_ratio,
                             downsample_rate, num_receivers, dest_row_start,
                             dest_row_tiles)
