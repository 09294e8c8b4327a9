"""Pillar voxelization for PointPillars on the device (port of
``hmvit_tpu/ops/voxelize.py``, rank-capped sorted path).

Padded raw points go in; one stable sort by pillar id enforces the
keep-first-K-in-order point cap, log-shift segmented scans over the
sorted points give the per-pillar cluster sums and maxima, and the dense
BEV grid is a gather of each pillar's last kept point — no ragged
tensor and no wide scatter.
"""
from __future__ import annotations

import math

import torch


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
              max_points_per_pillar: int = 32):
    """Assign points (N, P, 4) to pillars and compute pillar statistics.

    Pillar ids are offset by cloud index so the whole fleet shares one
    sort.  Returns a dict of flat, pillar-sorted per-point tensors:
    ``points``, ``pillar_id`` (N*nx*ny = overflow), ``keep`` (in range and
    under the per-pillar cap), ``mean_xyz``, ``center_offset``,
    ``count_per_point``, plus ``num_clouds``."""
    nx, ny = int(grid_size[0]), int(grid_size[1])
    nz = int(grid_size[2]) if len(grid_size) > 2 else 1
    dev = points.device
    n_clouds, pts_per = points.shape[:2]
    cloud_idx = torch.arange(n_clouds, device=dev).repeat_interleave(pts_per)
    points = points.reshape(-1, points.shape[-1])
    points_mask = points_mask.reshape(-1)
    num_pillars = n_clouds * nx * ny * nz
    vsize = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    prange = torch.tensor(pc_range, dtype=torch.float32, device=dev)

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
    centers = (gi_s.to(torch.float32) + 0.5) * vsize + prange[:3]
    return {
        "points": points_s,
        "pillar_id": sorted_pid,
        "keep": keep,
        "mean_xyz": mean_xyz,
        "center_offset": xyz_s - centers,
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


def scatter_max_to_bev(point_features, pillar_id, keep, grid_size,
                       num_clouds: int = 1, max_run: int | None = None):
    """Max-pool pillar-sorted per-point features (P, C) into the dense
    (num_clouds, ny, nx, C) grid; empty cells are 0.  A segmented
    max-scan leaves each pillar's maximum at its last kept point, and the
    grid gathers those rows."""
    nx, ny = int(grid_size[0]), int(grid_size[1])
    num_pillars = num_clouds * nx * ny
    p = point_features.shape[0]
    dev = point_features.device
    steps = scan_steps(max_run, p)
    pid2 = torch.where(keep, pillar_id, -1)
    scanned = segmented_scan(point_features, pid2, steps, torch.maximum,
                             float("-inf"))
    scanned = scanned * keep[:, None].to(scanned.dtype)
    iota = torch.arange(1, p + 1, device=dev)
    last_kept = torch.zeros(num_pillars + 1, dtype=torch.int64, device=dev)
    last_kept = last_kept.scatter_reduce(
        0, pillar_id, torch.where(keep, iota, 0), reduce="amax")[:-1]
    feat = scanned[torch.clamp(last_kept - 1, min=0)]
    dense = torch.where((last_kept > 0)[:, None], feat,
                        torch.zeros((), dtype=feat.dtype, device=dev))
    return dense.reshape(num_clouds, ny, nx, -1)
