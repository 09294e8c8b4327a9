"""Bilinear feature sampling at arbitrary continuous coordinates (port of
``hmvit_tpu/ops/sampling.py``).

Deformable attention's irregular reads.  :func:`bilinear_sample` is the
gather of the 4 neighbours of each sample point, then the lerp,
vectorised over every leading axis: plain PyTorch, as in the JAX
package, where this is XLA gathers and no Pallas kernel.

:func:`ms_deform_attn` (multi-scale deformable attention, mmcv's
contract) launches the port's own CUDA kernel, ``csrc/ms_deform_attn.cu``
(the JAX package has no Pallas kernel to port here), for CUDA tensors,
and runs its plain twin :func:`ms_deform_attn_xla` for CPU tensors and
under :func:`hmvit_tpu_torch.ops.plain_ops`.  Its backward is the twin's
recompute.  Nothing here reads back to the host, so a CUDA graph can
capture either path.
"""
from __future__ import annotations

import torch

from . import cuda, use_kernel
from ..tracing import twin_backward

# csrc/ms_deform_attn.cu: the levels one launch takes
MAX_LEVELS = 4


def bilinear_sample(feats, coords):
    """Sample (B, H, W, C) features at continuous pixel coordinates.

    coords: (B, Q, 2) as (x, y) in pixel units, pixel i's centre at i;
    a tap outside the map reads 0.  Returns (B, Q, C)."""
    b, h, w, c = feats.shape
    x, y = coords[..., 0], coords[..., 1]
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    x1, y1 = x0 + 1, y0 + 1
    wx = (x - x0).to(feats.dtype)[..., None]
    wy = (y - y0).to(feats.dtype)[..., None]
    flat = feats.reshape(b, h * w, c)

    def gather(yy, xx):
        valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        idx = (torch.clamp(yy, 0, h - 1) * w
               + torch.clamp(xx, 0, w - 1)).long()
        vals = torch.gather(flat, 1, idx[..., None].expand(*idx.shape, c))
        return torch.where(valid[..., None], vals, torch.zeros_like(vals))

    top = gather(y0, x0) * (1 - wx) + gather(y0, x1) * wx
    bot = gather(y1, x0) * (1 - wx) + gather(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def ms_deform_attn_xla(value, spatial_shapes, sampling_locations,
                       attention_weights):
    """Plain twin of :func:`ms_deform_attn`: a :func:`bilinear_sample`
    per level, then the weighted sum over (L, P) as a batched gemv."""
    b, _, h, d = value.shape
    q, _, num_l, p = sampling_locations.shape[1:5]
    outs = []
    start = 0
    for lvl in range(num_l):
        hh, ww = (int(s) for s in spatial_shapes[lvl])
        v = value[:, start:start + hh * ww]
        start += hh * ww
        v = v.reshape(b, hh, ww, h, d).permute(0, 3, 1, 2, 4)
        v = v.reshape(b * h, hh, ww, d)
        loc = sampling_locations[:, :, :, lvl]  # (B, Q, H, P, 2)
        # pixel units: x * w - 0.5, y * h - 0.5
        pix = torch.stack([loc[..., 0] * ww, loc[..., 1] * hh], -1) - 0.5
        pix = pix.permute(0, 2, 1, 3, 4).reshape(b * h, q * p, 2)
        outs.append(bilinear_sample(v, pix).reshape(b, h, q, p, d))
    stacked = torch.stack(outs, 3)  # (B, H, Q, L, P, D)
    w = attention_weights.permute(0, 2, 1, 3, 4)  # (B, H, Q, L, P)
    out = torch.einsum("bhqlp,bhqlpd->bhqd", w, stacked)
    return out.permute(0, 2, 1, 3).reshape(b, q, h * d)


def _static_shapes(spatial_shapes) -> tuple[tuple[int, int], ...]:
    """The levels' (h, w) as host ints.  A tensor is refused: reading it
    would be a device-to-host copy in the serving path."""
    if isinstance(spatial_shapes, torch.Tensor):
        raise TypeError("ms_deform_attn: spatial_shapes must be host ints "
                        "(a list of (h, w)), not a tensor")
    shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    if not 1 <= len(shapes) <= MAX_LEVELS or \
            min(min(s) for s in shapes) < 1:
        raise ValueError(f"ms_deform_attn: levels {shapes}: the kernel "
                         f"takes 1 to {MAX_LEVELS} levels of positive size")
    return shapes


def ms_deform_attn_launch(value, spatial_shapes, sampling_locations,
                          attention_weights):
    """Validate and lay out one launch of ``csrc/ms_deform_attn.cu``:
    returns (launch, out) where ``launch()`` runs the kernel into ``out``
    (B, Q, H D).  Raises on what the kernel does not take; checks the
    types, shapes and layouts before the device, so a CPU run reaches each
    check."""
    shapes = _static_shapes(spatial_shapes)
    dt = value.dtype
    if dt not in cuda.DTYPE_CODES or attention_weights.dtype != dt:
        raise TypeError(f"ms_deform_attn: value {dt} and weights "
                        f"{attention_weights.dtype} must be one of "
                        f"{tuple(cuda.DTYPE_CODES)}")
    if sampling_locations.dtype != torch.float32:
        raise TypeError(f"ms_deform_attn: sampling locations must be "
                        f"float32, got {sampling_locations.dtype}")
    if value.ndim != 4 or sampling_locations.ndim != 6:
        raise ValueError(f"ms_deform_attn: value {tuple(value.shape)} must "
                         f"be (B, K, H, D), locations "
                         f"{tuple(sampling_locations.shape)} (B, Q, H, L, "
                         f"P, 2)")
    b, k, h, d = value.shape
    q, num_l, p = (sampling_locations.shape[i] for i in (1, 3, 4))
    if tuple(sampling_locations.shape) != (b, q, h, num_l, p, 2) or \
            tuple(attention_weights.shape) != (b, q, h, num_l, p) or \
            num_l != len(shapes) or \
            sum(hh * ww for hh, ww in shapes) != k:
        raise ValueError(f"ms_deform_attn: value {tuple(value.shape)}, "
                         f"locations {tuple(sampling_locations.shape)}, "
                         f"weights {tuple(attention_weights.shape)} and "
                         f"levels {shapes} do not fit")
    if k * h * d >= 2 ** 31 or q * h >= 2 ** 31 or b > 65535:
        raise ValueError(f"ms_deform_attn: value {tuple(value.shape)} or "
                         f"{q} queries exceed the kernel's 32-bit offsets "
                         f"or its 65535 batch rows")
    tensors = (value, sampling_locations, attention_weights)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ms_deform_attn: value, locations and weights "
                         "must be contiguous")
    if not value.is_cuda or any(t.device != value.device for t in tensors):
        raise ValueError(f"ms_deform_attn: the kernel takes tensors on one "
                         f"CUDA device, got "
                         f"{[str(t.device) for t in tensors]}")
    out = torch.empty((b, q, h * d), dtype=dt, device=value.device)
    levels = [n for s in shapes for n in s]
    levels += [0] * (2 * MAX_LEVELS - len(levels))
    ints = [cuda.DTYPE_CODES[dt], b, k, q, h, d, num_l, p, *levels]
    return (lambda: cuda.MS_DEFORM_ATTN.launch([*tensors, out], ints),
            out)


class _MSDeformAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, value, shapes, sampling_locations, attention_weights):
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        ctx.shapes = shapes
        launch, out = ms_deform_attn_launch(value, shapes,
                                            sampling_locations,
                                            attention_weights)
        launch()
        return out

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = [ctx.needs_input_grad[i] for i in (0, 2, 3)]
        with twin_backward("ms_deform_attn"), torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(saved, need)]
            out = ms_deform_attn_xla(inputs[0], ctx.shapes, *inputs[1:])
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(out, wanted, g))
        gv, gl, gw = (next(grads) if n else None for n in need)
        return gv, None, gl, gw


def ms_deform_attn(value, spatial_shapes, sampling_locations,
                   attention_weights):
    """Multi-scale deformable attention, mmcv's calling contract.

    value: (B, K, H, D) with K = sum(h * w) over the levels; each head
    reads only its own D-channel slice.  spatial_shapes: (h, w) per level
    (static host ints).  sampling_locations: (B, Q, H, L, P, 2) as (x, y)
    in [0, 1], ``grid_sample(align_corners=False)``'s convention (0 and 1
    are the image's edges, pixel centres at (i + 0.5) / size).
    attention_weights: (B, Q, H, L, P), normalised over (L, P) by the
    caller.  Returns (B, Q, H * D).

    The CUDA kernel forward (the twin's backward) for CUDA tensors: value
    and weights in one type, float32 or bfloat16, float32 locations, up
    to 4 levels, all contiguous; anything else raises.  The plain twin
    for CPU tensors and under ``plain_ops()``."""
    if use_kernel(value):
        return _MSDeformAttn.apply(value, spatial_shapes,
                                   sampling_locations, attention_weights)
    return ms_deform_attn_xla(value, spatial_shapes, sampling_locations,
                              attention_weights)
