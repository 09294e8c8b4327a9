"""One-pass segmented max-scan for the pillar scatter (port of
``hmvit_tpu/ops/segscan.py``).

:func:`fused_segmented_max_scan` launches the CUDA kernel of
``csrc/segscan.cu`` (the replacement of the Pallas ``_kernel``) for CUDA
tensors and runs :func:`segmented_max_scan_plain` — the log-shift scan of
:func:`hmvit_tpu_torch.ops.voxelize.segmented_scan` with
``torch.maximum`` and ``-inf`` — for CPU tensors or under
:func:`hmvit_tpu_torch.ops.plain_ops`.  Its backward differentiates the
plain version, as the JAX wrapper's does.

The contract is the log-shift scan's on ids whose non-negative values
each occupy one run of at most ``2**steps`` consecutive rows: the last
row of a run holds the run's maximum, and the two agree bit for bit on
every row whose id is >= 0.  Rows of a negative ("dropped") id are
unspecified on both sides and must not be compared or consumed.

The JAX gate (``C % 8 == 0`` and a row-block divisor of P that is at
least 512) answered the TPU's fast memory and is dropped: any P and any
C run here.  With ``C % 8 == 0`` a thread moves 8 channels as whole
words; any other C takes one channel per thread.  The kernel scans tiles
of rows (:func:`scan_plan` mirrors their size), and runs longer than a
tile take a second launch inside the same call.
"""
from __future__ import annotations

import torch

from . import cuda, use_kernel
from ..tracing import twin_backward
from .voxelize import segmented_scan


# csrc/segscan.cu: threads a block, rows a thread scans, channel vectors
# a block
THREADS, SLICE, MAX_GROUP = 256, 8, 32


def scan_plan(c: int, steps: int) -> tuple[int, bool]:
    """(rows a tile, whether the call takes the second launch) of the
    kernel for C channels: a block of 256 threads, each over 8 rows of
    one vector of 8 channels (one channel when C % 8 != 0), up to 32
    vectors a block; the second launch carries runs longer than a tile
    (2**steps - 1 > rows).  Mirrors ``hm_segmented_max_scan_plan``."""
    cvecs = c // 8 if c % 8 == 0 else c
    rows = THREADS // min(cvecs, MAX_GROUP) * SLICE
    return rows, (1 << steps) - 1 > rows


def segmented_max_scan_plain(vals, seg_id, steps: int = 5):
    """Plain version: ``steps`` log-shift passes over (P, C)."""
    return segmented_scan(vals, seg_id, steps, torch.maximum, float("-inf"))


def segmented_max_scan_launch(vals, seg_id, steps: int = 5,
                              previous: bool = False):
    """Validate and lay out one launch: returns (launch, out) where
    ``launch()`` runs the kernel into ``out`` (P, C).  ``previous`` runs
    the kernel's previous body (same bits on rows whose id is >= 0): for
    timing and as the on-card anchor only."""
    if vals.dtype not in cuda.DTYPE_CODES:
        raise TypeError(f"segmented max-scan: unsupported dtype {vals.dtype}")
    if vals.ndim != 2 or tuple(seg_id.shape) != (vals.shape[0],):
        raise ValueError(f"segmented max-scan: vals {tuple(vals.shape)} and "
                         f"ids {tuple(seg_id.shape)} do not fit")
    p, c = vals.shape
    if not 0 <= steps <= 30:
        raise ValueError(f"segmented max-scan: steps {steps} not in [0, 30]")
    vals = vals.contiguous()
    if vals.data_ptr() % 16:
        vals = vals.clone()
    ids = seg_id.to(torch.int32).contiguous()
    out = torch.empty_like(vals)
    ints = [cuda.DTYPE_CODES[vals.dtype], p, c, steps]
    kernel = (cuda.SEGMENTED_MAX_SCAN_PREVIOUS if previous
              else cuda.SEGMENTED_MAX_SCAN)
    return lambda: kernel.launch([vals, ids, out], ints), out


class _SegmentedMaxScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals, seg_id, steps):
        ctx.save_for_backward(vals, seg_id)
        ctx.steps = steps
        launch, out = segmented_max_scan_launch(vals, seg_id, steps)
        launch()
        return out

    @staticmethod
    def backward(ctx, g):
        vals, seg_id = ctx.saved_tensors
        with twin_backward("segmented_max_scan"), torch.enable_grad():
            v = vals.detach().requires_grad_()
            out = segmented_max_scan_plain(v, seg_id, ctx.steps)
            (gv,) = torch.autograd.grad(out, v, g)
        return gv, None, None


def fused_segmented_max_scan(vals, seg_id, steps: int = 5):
    """Inclusive segmented max-scan of vals (P, C) over the runs of
    seg_id (P,): CUDA kernel forward (plain-version backward) for CUDA
    tensors; the plain version for CPU tensors and under ``plain_ops()``.
    Runs of ids >= 0 must be at most ``2**steps`` rows long."""
    if use_kernel(vals):
        return _SegmentedMaxScan.apply(vals, seg_id, steps)
    return segmented_max_scan_plain(vals, seg_id, steps)
