"""Pillar voxelization for PointPillars on the device (port of
``hmvit_tpu/ops/voxelize.py``).

Padded raw points go in; one stable sort by pillar id enforces the
keep-first-K-in-order point cap, log-shift segmented scans over the
sorted points give the per-pillar cluster sums and maxima, and the dense
BEV grid is a gather of each pillar's last kept point — no ragged
tensor and no wide scatter.  Beside that default route
:func:`scatter_max_to_bev` has the one-pass scan kernel
(``use_scan_kernel``), the compaction + expansion kernels
(``use_expand_kernel``) and, for the cap-free :func:`pillarize`
(``enforce_cap=False``: no sort, every in-range point kept), an unsorted
segment maximum.
"""
from __future__ import annotations

import math

import torch

from ..utils.constants import device_constant


def _shifted(x, s: int, fill):
    """x shifted DOWN by s (x[i] -> x[i-s]), front-filled with ``fill``."""
    pad = torch.full((s, *x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([pad, x[:-s]], dim=0)


def segmented_scan(vals, seg_id, steps: int, op, identity):
    """Inclusive Hillis-Steele scan of ``op`` within consecutive runs of
    equal ``seg_id``; 2**steps must cover the longest run."""
    for k in range(steps):
        s = 1 << k
        same = (seg_id == _shifted(seg_id, s, -1))[:, None]
        prev = _shifted(vals, s, identity)
        vals = torch.where(same, op(vals, prev), vals)
    return vals


def segmented_run_totals(vals, seg_id, steps: int, op, identity):
    """Every element receives its full run's ``op``-reduction."""
    fwd = segmented_scan(vals, seg_id, steps, op, identity)
    bwd_inc = segmented_scan(vals.flip(0), seg_id.flip(0), steps, op,
                             identity).flip(0)
    same_next = torch.cat([seg_id[1:] == seg_id[:-1],
                           torch.zeros(1, dtype=torch.bool,
                                       device=seg_id.device)])[:, None]
    nxt = torch.cat([bwd_inc[1:], bwd_inc[:1]])
    bwd_exc = torch.where(same_next, nxt,
                          torch.full((), identity, dtype=vals.dtype,
                                     device=vals.device))
    return op(fwd, bwd_exc)


def scan_steps(max_run: int | None, p: int) -> int:
    return max(1, math.ceil(math.log2(max(2, min(max_run or p, p)))))


def pillarize(points, points_mask, voxel_size, pc_range, grid_size,
              max_points_per_pillar: int = 32, enforce_cap: bool = True):
    """Assign points (N, P, 4) to pillars and compute pillar statistics.

    Pillar ids are offset by cloud index so the whole fleet shares one
    sort.  Returns a dict of flat per-point tensors, pillar-sorted when
    ``enforce_cap``: ``points``, ``pillar_id`` (N*nx*ny = overflow),
    ``keep`` (in range and under the per-pillar cap), ``mean_xyz``,
    ``center_offset``, ``count_per_point``, plus ``num_clouds``.

    ``enforce_cap=False`` is the cap-free path: no sort, input order,
    every in-range point kept, and the per-pillar sums taken with
    ``index_add_`` — whose float atomics on a CUDA device add in no fixed
    order, so ``mean_xyz`` may differ in its last bits between runs."""
    nx, ny = int(grid_size[0]), int(grid_size[1])
    nz = int(grid_size[2]) if len(grid_size) > 2 else 1
    dev = points.device
    n_clouds, pts_per = points.shape[:2]
    cloud_idx = torch.arange(n_clouds, device=dev).repeat_interleave(pts_per)
    points = points.reshape(-1, points.shape[-1])
    points_mask = points_mask.reshape(-1)
    num_pillars = n_clouds * nx * ny * nz
    vsize = device_constant(tuple(voxel_size), torch.float32, dev)
    prange = device_constant(tuple(pc_range), torch.float32, dev)

    def grid_index(xyz):
        return torch.floor((xyz - prange[:3]) / vsize).to(torch.int64)

    def in_range_of(gi, mask):
        return ((gi[:, 0] >= 0) & (gi[:, 0] < nx) & (gi[:, 1] >= 0)
                & (gi[:, 1] < ny) & (gi[:, 2] >= 0) & (gi[:, 2] < nz)
                & (mask > 0))

    gi = grid_index(points[:, :3])
    in_range = in_range_of(gi, points_mask)
    cell = ((cloud_idx * nz + gi[:, 2]) * ny + gi[:, 1]) * nx + gi[:, 0]
    pid = torch.where(in_range, cell, torch.full_like(cell, num_pillars))

    def centers_of(g):
        return (g.to(torch.float32) + 0.5) * vsize + prange[:3]

    if not enforce_cap:
        keep_f = in_range.to(torch.float32)
        xyz = points[:, :3]
        count = torch.zeros(num_pillars + 1, dtype=torch.float32,
                            device=dev).index_add_(0, pid, keep_f)
        sums = torch.zeros((num_pillars + 1, 3), dtype=torch.float32,
                           device=dev).index_add_(0, pid,
                                                  xyz * keep_f[:, None])
        mean = sums / torch.clamp(count[:, None], min=1.0)
        return {
            "points": points,
            "pillar_id": pid,
            "keep": in_range,
            "mean_xyz": mean[pid],
            "center_offset": xyz - centers_of(gi),
            "count_per_point": count[pid],
            "num_clouds": n_clouds,
        }

    # stable: keeps the input order within a pillar for the point cap
    sorted_pid, order = torch.sort(pid, stable=True)
    packed = torch.cat([points, points_mask.to(points.dtype)[:, None]], dim=1)
    packed_s = packed[order]
    points_s = packed_s[:, :points.shape[1]]
    gi_s = grid_index(points_s[:, :3])
    in_range_s = in_range_of(gi_s, packed_s[:, points.shape[1]])

    p = pid.shape[0]
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sorted_pid[1:] != sorted_pid[:-1]])
    idx = torch.arange(p, device=dev)
    seg_start = torch.cummax(torch.where(is_new, idx, 0), dim=0).values
    keep = in_range_s & ((idx - seg_start) < max_points_per_pillar)

    keep_f = keep.to(torch.float32)
    xyz_s = points_s[:, :3]
    steps = scan_steps(max_points_per_pillar, p)
    pid2 = torch.where(keep, sorted_pid, -1)
    vals = torch.cat([xyz_s * keep_f[:, None], keep_f[:, None]], dim=1)
    tot = segmented_run_totals(vals, pid2, steps, torch.add, 0.0)
    count_pt = tot[:, 3]
    mean_xyz = tot[:, :3] / torch.clamp(count_pt[:, None], min=1.0)
    return {
        "points": points_s,
        "pillar_id": sorted_pid,
        "keep": keep,
        "mean_xyz": mean_xyz,
        "center_offset": xyz_s - centers_of(gi_s),
        "count_per_point": count_pt,
        "num_clouds": n_clouds,
    }


def pillar_point_features(pillar_info, use_absolute_xyz: bool = True,
                          with_distance: bool = False):
    """Per-point PFN input [xyz, intensity, xyz - cluster mean,
    xyz - pillar center (, |xyz|)], zeroed for dropped points."""
    points = pillar_info["points"]
    xyz = points[:, :3]
    feats = [points if use_absolute_xyz else points[:, 3:],
             xyz - pillar_info["mean_xyz"], pillar_info["center_offset"]]
    if with_distance:
        feats.append(torch.linalg.norm(xyz, dim=1, keepdim=True))
    out = torch.cat(feats, dim=1)
    return out * pillar_info["keep"][:, None].to(out.dtype)


def compact_pillar_rows(scanned, pillar_id, pid2, keep, num_pillars: int):
    """One row per non-empty pillar, in cell order, at a static shape:
    (comp (P, C), comp_ids (P,) int32).  The last kept row of each run
    holds the pillar's maximum; a stable argsort of "not such a row"
    moves those rows to the front in order, and every other row becomes
    fill with id ``num_pillars``.  (``torch.nonzero`` would size its
    result by the data and stall the host on the count.)"""
    nxt = torch.cat([pid2[1:], pid2.new_full((1,), -1)])
    is_last = keep & (pid2 != nxt)
    order = torch.argsort(~is_last, stable=True)
    comp_ids = torch.where(is_last, pillar_id,
                           num_pillars)[order].to(torch.int32)
    return scanned[order], comp_ids


def last_kept_rows(scanned, pillar_id, keep, num_pillars: int):
    """(num_pillars, C): each pillar's row of ``scanned`` at its last kept
    point (pillar-sorted rows, where an inclusive segmented scan leaves
    the pillar's total), 0 for a pillar without one."""
    p = scanned.shape[0]
    iota = torch.arange(1, p + 1, device=scanned.device)
    last_kept = torch.zeros(num_pillars + 1, dtype=torch.int64,
                            device=scanned.device)
    last_kept = last_kept.scatter_reduce(
        0, pillar_id, torch.where(keep, iota, 0), reduce="amax")[:-1]
    # index_select, not scanned[...]: the same rows, but its backward is
    # an index_add; an indexing backward sorts the indices and sums each
    # run serially, and every empty cell points at row 0 (907 ms of a
    # 1434 ms train step on an H100)
    feat = scanned.index_select(0, torch.clamp(last_kept - 1, min=0))
    return torch.where((last_kept > 0)[:, None], feat,
                       torch.zeros((), dtype=scanned.dtype,
                                   device=scanned.device))


def scatter_max_to_bev(point_features, pillar_id, keep, grid_size,
                       num_clouds: int = 1, sorted_ids: bool = True,
                       max_run: int | None = None,
                       use_expand_kernel: bool | str = False,
                       use_scan_kernel: bool = False):
    """Max-pool per-point features (P, C) into the dense grid
    (num_clouds, ny, nx, C), or (num_clouds, nz, ny, nx, C) for a 3-axis
    grid; empty cells are 0.

    With sorted ids a segmented max-scan leaves each pillar's maximum at
    its last kept point — the log-shift scan, or with ``use_scan_kernel``
    the one-pass kernel of :mod:`.segscan` — and the grid gathers those
    rows.  ``use_expand_kernel`` (True or ``"v1"``, or ``"v2"``) builds
    the grid instead by compacting one row per non-empty pillar and
    expanding with a kernel of :mod:`.expand`.  Neither knob depends on
    the shapes: the JAX package's gates (C % 8, a row-block divisor,
    ``num_pillars % 4096``) answered the TPU and are not kept.  Unsorted
    ids (the cap-free path) take one segment maximum over the points."""
    nx, ny = int(grid_size[0]), int(grid_size[1])
    nz = int(grid_size[2]) if len(grid_size) > 2 else 1
    num_pillars = num_clouds * nx * ny * nz
    p, c = point_features.shape
    dev = point_features.device
    zero = torch.zeros((), dtype=point_features.dtype, device=dev)

    if not sorted_ids:
        neg = torch.where(keep[:, None], point_features,
                          torch.full_like(zero, float("-inf")))
        dense = torch.full((num_pillars + 1, c), float("-inf"),
                           dtype=neg.dtype, device=dev)
        dense = dense.scatter_reduce(
            0, pillar_id[:, None].expand(-1, c), neg, reduce="amax")
        dense = torch.where(torch.isfinite(dense), dense, zero)[:-1]
    else:
        steps = scan_steps(max_run, p)
        pid2 = torch.where(keep, pillar_id, -1)
        if use_scan_kernel:
            from .segscan import fused_segmented_max_scan

            scanned = fused_segmented_max_scan(point_features, pid2, steps)
        else:
            scanned = segmented_scan(point_features, pid2, steps,
                                     torch.maximum, float("-inf"))
        scanned = scanned * keep[:, None].to(scanned.dtype)
        if use_expand_kernel:
            from .expand import expand_rows_to_dense, expand_rows_to_dense_v2

            comp, comp_ids = compact_pillar_rows(scanned, pillar_id, pid2,
                                                 keep, num_pillars)
            fn = (expand_rows_to_dense_v2 if use_expand_kernel == "v2"
                  else expand_rows_to_dense)
            dense = fn(comp, comp_ids, num_pillars)
        else:
            dense = last_kept_rows(scanned, pillar_id, keep, num_pillars)

    if nz > 1:
        return dense.reshape(num_clouds, nz, ny, nx, -1)
    return dense.reshape(num_clouds, ny, nx, -1)
