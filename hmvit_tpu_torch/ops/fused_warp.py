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
"""
from __future__ import annotations

import torch

from . import cuda, use_kernel
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


def pair_warp_xla(src_typed, pairwise, mode, discrete_ratio,
                  downsample_rate, num_receivers=None):
    """Plain twin: type gather + separable warp.

    src_typed (B, TY, J, H, W, C); pairwise (B, L, L, 4, 4) with
    pairwise[b, j, i] mapping j's frame into i's; mode (B, L) receiver
    variant.  Returns (B, I, J, H, W, C)."""
    bsz, _, l, h, w, ck = src_typed.shape
    r = l if num_receivers is None else num_receivers
    bidx = torch.arange(bsz, device=src_typed.device)[:, None]
    typed = src_typed[bidx, mode[:, :r].long()]  # (B, I, J, H, W, C)
    t_ij = pairwise.transpose(1, 2)[:, :r]
    return warp_bev_mxu(
        typed.reshape(bsz * r, l, h, w, ck),
        t_ij.reshape(bsz * r, l, 4, 4),
        discrete_ratio, downsample_rate,
    ).reshape(bsz, r, l, h, w, ck)


# the resident kernel stages 8 bytes per pixel of one whole source map
# in a block's shared memory (227 KB on Hopper)
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
                     variant: str = "auto"):
    """Validate and lay out one pair-warp launch: returns (launch, out)
    where ``launch()`` runs the kernel into ``out`` (B, I, J, H, W, C).
    ``coef`` is the frame's :func:`pair_warp_coefficients` of
    ``pairwise``, or None to compute them here."""
    bsz, ty_count, l, h, w, ck = src_typed.shape
    kernel = (cuda.PAIR_WARP_RESIDENT
              if resolve_variant(variant, h, w) == "resident"
              else cuda.PAIR_WARP)
    r = l if num_receivers is None else num_receivers
    if src_typed.dtype not in cuda.DTYPE_CODES:
        raise TypeError(f"pair warp: unsupported dtype {src_typed.dtype}")
    if h != w or ck % 8:
        raise ValueError(f"pair warp needs square maps and C % 8 == 0, "
                         f"got {(h, w, ck)}")
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
    out = torch.empty((bsz, r, l, h, w, ck), dtype=src.dtype,
                      device=src.device)
    ints = [cuda.DTYPE_CODES[src.dtype], bsz * r, l, ty_count, r, h, w, ck]
    return lambda: kernel.launch([src, coef, rtype, out], ints), out


class _PairWarp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src_typed, pairwise, mode, dr, ds, nr, coef, variant):
        ctx.save_for_backward(src_typed, pairwise, mode)
        ctx.args = (dr, ds, nr)
        launch, out = pair_warp_launch(src_typed, pairwise, mode, dr, ds, nr,
                                       coef, variant)
        launch()
        return out

    @staticmethod
    def backward(ctx, g):
        src, pairwise, mode = ctx.saved_tensors
        with torch.enable_grad():
            s = src.detach().requires_grad_()
            out = pair_warp_xla(s, pairwise, mode, *ctx.args)
            (gs,) = torch.autograd.grad(out, s, g)
        return gs, None, None, None, None, None, None, None


def fused_pair_warp(src_typed, pairwise, mode, discrete_ratio,
                    downsample_rate, num_receivers=None, coef=None,
                    variant: str = "auto"):
    """CUDA kernel forward (plain-twin backward) for CUDA tensors; the
    plain twin for CPU tensors and under ``plain_ops()``.  ``coef``, the
    frame's :func:`pair_warp_coefficients`, spares the kernel path its
    geometry; the plain twin derives its own from ``pairwise``.
    ``variant`` picks the kernel (:func:`resolve_variant`); both give
    the same bits, and the twin is the same for both."""
    resolve_variant(variant, *src_typed.shape[3:5])
    if use_kernel(src_typed):
        return _PairWarp.apply(src_typed, pairwise, mode, discrete_ratio,
                               downsample_rate, num_receivers, coef, variant)
    return pair_warp_xla(src_typed, pairwise, mode, discrete_ratio,
                         downsample_rate, num_receivers)
