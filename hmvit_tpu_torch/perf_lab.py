"""Stage-level timing of the kernels on the card (counterpart of the
fusion, lidar and expansion stages of the JAX package's ``perf_lab.py``)
and what the program's tracer reads on a served frame and a train step.

    python -m hmvit_tpu_torch.perf_lab [stage ...] [--iters N] [--cpu]

Stages (default: all), at the production shapes B = 1, 128^2 x 256 maps,
8 heads of 32, window 8, two type variants; 2 lidar clouds of 30 000
points on a 512^2 pillar grid, PFN width 64:

* ``attn`` — the typed window-attention kernel, L = 5, in float32 (the
  fp32 CUDA-core body) and bfloat16 (the tensor-core body);
* ``pairwarp`` — the pair-warp tile kernel, L = 4 and 5, bfloat16;
* ``pairwarp_res`` — the resident pair-warp kernel beside the tile
  kernel, (L, receivers) = (4, all), (5, all), (4, 1); the outputs must
  be equal bit for bit; then the resident kernel's destination-row
  windows (the SP shards of 2 and 4 of the 128-row map), L = 4, every
  window equal to the whole launch's rows bit for bit (untimed);
* ``fused_wa`` — the fused warp + attention kernel beside the pair warp
  followed by the stripe attention kernel, L = 4, L = 4 with one
  receiver, L = 5; equal bit for bit;
* ``segscan`` — the one-pass segmented max-scan kernel beside the
  log-shift scan, bfloat16, on the pillar ids of two synthetic scene
  clouds (mostly padding and short runs) and of two dense clouds (every
  point in range, about 24 to a pillar, runs up to the cap of 32); equal
  bit for bit on every row whose id is >= 0;
* ``expand`` — 40 000 sorted rows -> the 2 x 512^2 x 64 bfloat16 grid:
  the plain version, the v1 and v2 expansion kernels and the one library
  call (``torch.zeros`` + ``index_copy_``, a yardstick only); all equal
  bit for bit;
* ``lidar`` — ``PillarFeatureNet`` alone, bfloat16 features, on two
  clouds of 30 000 in-range points: ``scatter_variant`` False, "v1",
  "v2", and the default route with the scan kernel; equal bit for bit;
* ``tracer`` — what the program's tracer (``tracing.py``) reads, and
  what it costs: on the production bfloat16 graph server, the device ms
  a frame between each stage's marks in the replayed graphs against the
  device-busy and host-to-device ms of 8 profiled frames, the spans and
  syncs a frame with the ``request`` span's ``request.host_cast_bytes``
  and ``request.pageable_bytes``, and the frame's host ms with the
  tracer off and on in turns; on the production train step
  (:func:`_train_case`, the numpy request copied each step), the step's
  host ms off and on in turns without the profiler, then a device-only
  trace of 2 steps with the tracer on, placed on the spans' clock by
  ``tracing.anchor()``: the device-idle ms under each outermost phase
  span (``request``, ``train.forward``, ``train.backward``,
  ``train.optimizer``) and the spans and syncs a step; then the FAX
  twin's sub-stages (the production model with the benchmark's
  ``hmvit_fax_ref`` camera block on a fleet of 4 camera agents): the
  device ms a replayed frame between each sub-stage's marks
  (``camera.trunk``, ``camera.cross_view.0`` / ``.1``,
  ``camera.self_attn``, ``camera.decoder``) against the ``camera`` mark,
  and an eager pass's spans, syncs and ``fax.score_elems`` a frame.

Times are CUDA-event medians of ``--iters`` calls of the wrapper (inputs
on the card, pose geometry included), each line with the card's name and
power limit.  Without a CUDA device the module fails; ``--cpu`` is a
rehearsal of the control flow on the kernels' plain twins at a tiny
size, whose times say nothing about the card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import tracing
from .data.anchors import generate_anchor_grid
from .data.synthetic import lidar_from_boxes, make_scene
from .models.hmvit import HMViT
from .models.pillar_encoder import PillarFeatureNet
from .nn import DTYPES, init_parameters
from .ops import plain_ops
from .ops.expand import (
    expand_rows_to_dense,
    expand_rows_to_dense_plain,
    expand_rows_to_dense_v2,
)
from .ops.fused_warp import fused_pair_warp
from .ops.fused_warp_attention import fused_warp_window_attention
from .ops.segscan import fused_segmented_max_scan
from .ops.voxelize import pillarize, scan_steps
from .ops.window_attention import (
    fused_stripe_window_attention,
    fused_window_attention,
)
from .serving import (
    PROD_CFG,
    anchor_args,
    batch_to_device,
    request_batch,
    serving_config,
    serving_hints,
)

LIDAR_RANGE = (-102.4, -102.4, -3.0, 102.4, 102.4, 1.0)


@dataclasses.dataclass(frozen=True)
class Shapes:
    hw: int = 128
    heads: int = 8
    dim_head: int = 32
    win: int = 8
    # the lidar encoder: pillar grid side, points per cloud, PFN width,
    # clouds, and the expand stage's non-empty pillars
    grid: int = 512
    points: int = 30000
    pfn: int = 64
    clouds: int = 2
    expand_rows: int = 40000

    @property
    def c(self) -> int:
        return self.heads * self.dim_head

    @property
    def voxel_size(self) -> tuple:
        side = (LIDAR_RANGE[3] - LIDAR_RANGE[0]) / self.grid
        return (side, side, LIDAR_RANGE[5] - LIDAR_RANGE[2])


PROD = Shapes()
TINY = Shapes(hw=64, heads=2, dim_head=8, grid=64, points=512, pfn=16,
              expand_rows=300)


class Lab:
    """One device, one seeded generator, one timing rule."""

    def __init__(self, device, shapes: Shapes, iters: int):
        self.dev = torch.device(device)
        self.shapes = shapes
        self.iters = iters
        self.gen = torch.Generator(device=self.dev).manual_seed(0)
        if self.dev.type == "cuda":
            self.where = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
        else:
            self.where = "cpu rehearsal, plain twins, not a device time"

    def randn(self, *shape, dtype=torch.float32):
        return torch.randn(*shape, generator=self.gen,
                           device=self.dev).to(dtype)

    def rand(self, *shape):
        return torch.rand(*shape, generator=self.gen, device=self.dev)

    def rand_pairwise(self, l: int, spread: float = 20.0):
        """Random rigid pairwise transforms (1, L, L, 4, 4);
        pairwise[b, j, i] = inv(M_i) @ M_j maps j's frame into i's.
        Positions uniform within +-``spread`` metres on each axis (20:
        every pair shares most of its view; 120 on the 204.8 m map:
        agents up to 240 m apart, about a quarter of the pairs' 32 x 32
        tiles out of view)."""
        ang = (self.rand(1, l) * 2 - 1) * np.pi
        pos = (self.rand(1, l, 2) * 2 - 1) * spread
        m = torch.eye(4, device=self.dev).repeat(1, l, 1, 1)
        m[:, :, 0, 0], m[:, :, 0, 1] = torch.cos(ang), -torch.sin(ang)
        m[:, :, 1, 0], m[:, :, 1, 1] = torch.sin(ang), torch.cos(ang)
        m[:, :, :2, 3] = pos
        return torch.einsum("bixy,bjyz->bjixz", torch.linalg.inv(m), m)

    def time_ms(self, fn) -> float:
        """Median ms of ``iters`` calls after 2 warm-up calls."""
        for _ in range(2):
            fn()
        if self.dev.type != "cuda":
            times = []
            for _ in range(self.iters):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))
        torch.cuda.synchronize()
        times = []
        for _ in range(self.iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def report(self, text: str):
        print(f"{text} [{self.where}]", flush=True)


def _name(dtype) -> str:
    return str(dtype).split(".")[-1]


def stage_attn_typed(lab: Lab, dtype=torch.float32, l: int = 5):
    """The typed kernel at production window counts."""
    s = lab.shapes
    t, wn, n = s.win ** 2, (s.hw // s.win) ** 2, l
    q = lab.randn(n, wn, t, s.c, dtype=dtype)
    k = lab.randn(n, l, wn, t, s.c, dtype=dtype)
    v = lab.randn(n, l, wn, t, s.c, dtype=dtype)
    wa = (lab.randn(n, l, s.heads, s.dim_head, s.dim_head) * 0.1).to(dtype)
    wm = (lab.randn(n, l, s.heads, s.dim_head, s.dim_head) * 0.1).to(dtype)
    bias = lab.randn(s.heads, t, t, dtype=dtype)
    mask = (lab.rand(n, l, wn, t) > 0.1).to(dtype)
    ms = lab.time_ms(lambda: fused_window_attention(
        q, k, v, wa, wm, bias, mask, s.heads, s.dim_head))
    lab.report(f"attn_typed L={l} {_name(dtype)}: {ms:.4f} ms")


def stage_pairwarp(lab: Lab, dtype=torch.bfloat16, l: int = 5,
                   variant: str = "tile", r: int | None = None):
    """One pair-warp kernel alone (typed K/V); returns its output."""
    s = lab.shapes
    kv = lab.randn(1, 2, l, s.hw, s.hw, 2 * s.c, dtype=dtype)
    pair = lab.rand_pairwise(l)
    mode = (torch.arange(l, device=lab.dev) % 2)[None]

    def run():
        return fused_pair_warp(kv, pair, mode, 0.4, 4.0, r, variant=variant)

    ms = lab.time_ms(run)
    lab.report(f"pair_warp L={l} R={r or l} {_name(dtype)} [{variant}]: "
               f"{ms:.4f} ms")
    return run()


def stage_pairwarp_res(lab: Lab, l: int, r: int | None):
    """Resident beside tile on the same inputs; equal bit for bit."""
    state = lab.gen.get_state()
    res = stage_pairwarp(lab, torch.bfloat16, l, "resident", r)
    lab.gen.set_state(state)
    tile = stage_pairwarp(lab, torch.bfloat16, l, "tile", r)
    if not torch.equal(res, tile):
        raise AssertionError(
            f"resident pair warp differs from the tile kernel at L={l} "
            f"R={r or l}: max|diff| "
            f"{float((res.float() - tile.float()).abs().max())}")


def stage_pairwarp_res_window(lab: Lab):
    """The resident kernel's destination-row windows at L = 4, the SP
    shards of 2 and 4 of the map: every shard's window equal to the whole
    launch's rows bit for bit (``chip_smoke.py``'s window check times
    them)."""
    s = lab.shapes
    kv = lab.randn(1, 2, 4, s.hw, s.hw, 2 * s.c, dtype=torch.bfloat16)
    pair = lab.rand_pairwise(4)
    mode = (torch.arange(4, device=lab.dev) % 2)[None]
    args = (kv, pair, mode, 0.4, 4.0)
    whole = fused_pair_warp(*args, variant="resident")
    for nsh in (2, 4):
        tiles = s.hw // 32 // nsh
        if tiles == 0 or s.hw % (32 * nsh):
            continue
        for k in range(nsh):
            win = fused_pair_warp(*args, variant="resident",
                                  dest_row_start=k * tiles,
                                  dest_row_tiles=tiles)
            rows = slice(k * tiles * 32, (k + 1) * tiles * 32)
            if not torch.equal(win, whole[:, :, :, rows]):
                raise AssertionError(
                    f"resident pair warp window {k} of {nsh} differs from "
                    f"the whole launch's rows")


def stage_fused_wa(lab: Lab, dtype=torch.bfloat16, l: int = 4,
                   r: int | None = None):
    """The fused kernel beside pair warp -> stripe attention."""
    s = lab.shapes
    n_recv = l if r is None else r
    src = lab.randn(1, 2, l, s.hw, s.hw, 2 * s.c, dtype=dtype)
    q = lab.randn(n_recv, s.hw, s.hw, s.c, dtype=dtype)
    mask = (lab.rand(n_recv, l, s.hw, s.hw) > 0.1).to(dtype)
    bias = (lab.randn(s.heads, s.win ** 2, s.win ** 2) * 0.1).to(dtype)
    pair = lab.rand_pairwise(l)
    mode = (torch.arange(l, device=lab.dev) % 2)[None]

    def split():
        kv_pair = fused_pair_warp(src, pair, mode, 0.4, 4.0, r)
        return fused_stripe_window_attention(
            q, kv_pair.reshape(n_recv, l, s.hw, s.hw, 2 * s.c), bias, mask,
            s.win, s.heads, s.dim_head)

    def fused():
        return fused_warp_window_attention(
            q, src, pair, mode, mask, bias, s.win, s.heads, s.dim_head, 0.4,
            4.0, r)

    diff = float((split().float() - fused().float()).abs().max())
    ms_split, ms_fused = lab.time_ms(split), lab.time_ms(fused)
    tag = f"L={l}" + (f" R={r}" if r else "")
    lab.report(f"warp+attn {tag} {_name(dtype)}: split {ms_split:.4f} ms, "
               f"fused {ms_fused:.4f} ms, max|diff|={diff:.3e}")
    if diff != 0.0:
        raise AssertionError(f"fused warp + attention differs from the "
                             f"split kernels at {tag}: max|diff| {diff}")


def _all_equal(what: str, outs: dict):
    """Every output equal to the first, bit for bit."""
    (ref_name, ref), *rest = outs.items()
    for name, out in rest:
        if not torch.equal(out, ref):
            diff = float((out.float() - ref.float()).abs().max())
            raise AssertionError(f"{what}: {name} differs from {ref_name}, "
                                 f"max|diff| {diff}")


def dense_clouds(gen, device, clouds: int, points: int, voxel_size,
                 lidar_range, per_pillar: int = 24):
    """(points (clouds, P, 4), mask (clouds, P)): every point in range,
    spread evenly over a square patch of pillars so that a pillar holds
    about ``per_pillar`` of them - runs near the cap of 32 and a few over
    it, where a scene cloud at this grid is mostly one-point pillars and
    padding."""
    side = max(1, round((points / per_pillar) ** 0.5))
    lo = torch.tensor(lidar_range[:3], device=device)
    span = torch.tensor([side * voxel_size[0], side * voxel_size[1],
                         lidar_range[5] - lidar_range[2]], device=device)
    u = torch.rand(clouds, points, 4, generator=gen, device=device)
    pts = torch.cat([lo + u[..., :3] * span, u[..., 3:]], dim=-1)
    return pts, torch.ones(clouds, points, device=device)


def stage_segscan(lab: Lab, dtype=torch.bfloat16):
    """The one-pass scan kernel beside the log-shift scan on the pillar
    ids of two kinds of cloud: synthetic scene clouds (mostly padding and
    short runs; vehicle walls give some long ones) and dense clouds (all
    points in range, runs near the cap, the capped rows as interleaved -1
    runs)."""
    s = lab.shapes
    rng = np.random.default_rng(0)
    vehicles, poses = make_scene(rng, s.clouds)
    scene = [lidar_from_boxes(rng, vehicles, pose, s.points)
             for pose in poses]
    cases = {
        "scene": tuple(torch.as_tensor(np.stack([c[k] for c in scene]),
                                       device=lab.dev) for k in (0, 1)),
        "dense": dense_clouds(lab.gen, lab.dev, s.clouds, s.points,
                              s.voxel_size, LIDAR_RANGE),
    }
    cap = 32
    for name, (pts, mask) in cases.items():
        info = pillarize(pts, mask, s.voxel_size, LIDAR_RANGE,
                         (s.grid, s.grid), cap)
        ids = torch.where(info["keep"], info["pillar_id"], -1)
        p = ids.shape[0]
        steps = scan_steps(cap, p)
        vals = lab.randn(p, s.pfn, dtype=dtype)

        def run():
            return fused_segmented_max_scan(vals, ids, steps)

        ms = lab.time_ms(run)
        got = run()
        with plain_ops():
            ms_plain = lab.time_ms(run)
            want = run()
        valid = ids >= 0
        runs = int((ids[1:] != ids[:-1]).sum()) + 1
        lab.report(f"segscan [{name}] P={p} C={s.pfn} steps={steps} "
                   f"{_name(dtype)} ({int(valid.sum())} rows with id >= 0 "
                   f"in {runs} runs): one-pass {ms:.4f} ms, log-shift "
                   f"{ms_plain:.4f} ms")
        _all_equal(f"segscan [{name}] on rows with id >= 0",
                   {"log-shift": want[valid], "one-pass": got[valid]})


def stage_expand(lab: Lab, dtype=torch.bfloat16):
    """Sorted compacted rows -> the dense grid: plain version, both
    kernels, and the library call."""
    s = lab.shapes
    num_cells = s.clouds * s.grid * s.grid
    ids = np.sort(np.random.RandomState(0).choice(
        num_cells, size=s.expand_rows, replace=False)).astype(np.int32)
    ids = torch.as_tensor(ids, device=lab.dev)
    ids_long = ids.long()
    comp = lab.randn(s.expand_rows, s.pfn, dtype=dtype)

    def library():
        out = torch.zeros((num_cells, s.pfn), dtype=dtype, device=lab.dev)
        return out.index_copy_(0, ids_long, comp)

    runs = {
        "plain": lambda: expand_rows_to_dense_plain(comp, ids, num_cells),
        "v1": lambda: expand_rows_to_dense(comp, ids, num_cells),
        "v2": lambda: expand_rows_to_dense_v2(comp, ids, num_cells),
        "library (zeros + index_copy_)": library,
    }
    outs = {}
    for name, run in runs.items():
        ms = lab.time_ms(run)
        outs[name] = run()
        lab.report(f"expand[{name}] {s.expand_rows} rows -> {num_cells}x"
                   f"{s.pfn} {_name(dtype)}: {ms:.4f} ms")
    _all_equal("expand", outs)


def stage_lidar(lab: Lab, dtype_name: str = "bfloat16"):
    """PillarFeatureNet alone on clouds of in-range points: the dense
    grid by each route."""
    s = lab.shapes
    lo = torch.tensor(LIDAR_RANGE[:3], device=lab.dev)
    hi = torch.tensor(LIDAR_RANGE[3:], device=lab.dev)
    pts = torch.cat([lo + lab.rand(s.clouds, s.points, 3) * (hi - lo),
                     lab.rand(s.clouds, s.points, 1)], dim=-1)
    mask = torch.ones(s.clouds, s.points, device=lab.dev)
    routes = {"scan + gather": {}, "expand v1": {"scatter_variant": "v1"},
              "expand v2": {"scatter_variant": "v2"},
              "scan kernel + gather": {"use_scan_kernel": True}}
    outs = {}
    for name, kwargs in routes.items():
        net = init_parameters(PillarFeatureNet(
            [s.pfn], s.voxel_size, LIDAR_RANGE, (s.grid, s.grid),
            compute_dtype=dtype_name, **kwargs), seed=0)
        net = net.to(lab.dev, DTYPES[dtype_name]).eval()
        ms = lab.time_ms(lambda: net(pts, mask))
        outs[name] = net(pts, mask)
        lab.report(f"pillar_pfn_scatter [{name}] {s.clouds}x{s.points} "
                   f"points -> {s.clouds}x{s.grid}^2x{s.pfn} {dtype_name}: "
                   f"{ms:.4f} ms")
    _all_equal("pillar_pfn_scatter", outs)


def rehearsal_cfg() -> dict:
    """The production model's structure at widths a CPU runs in seconds
    (64^2 pillars, 16^2 x 64 BEV, window 4, 4 heads of 16, 2 cameras of
    64^2): for the ``--cpu`` rehearsal of the tracer stage."""
    cfg = serving_config(PROD_CFG, bf16=False)
    rng = [-20.48, -20.48, -3.0, 20.48, 20.48, 1.0]
    lidar = cfg["lidar"]
    lidar.update(voxel_size=[0.64, 0.64, 4.0], lidar_range=rng)
    lidar["pillar_vfe"]["num_filters"] = [32]
    lidar["point_pillar_scatter"].update(num_features=32,
                                         grid_size=[64, 64, 1])
    lidar["base_bev_backbone"].update(
        layer_nums=[1, 1, 1], num_filters=[32, 32, 32],
        num_upsample_filter=[32, 32, 32])
    lidar["shrink_header"].update(dim=[64], input_dim=96)
    cfg["camera"].update(fpn_channels=16, dim=32, bev_size=16, out_dim=64,
                         num_layers=1, heads=2, window=4,
                         num_points_in_pillar=2, bev_range=20.48, num_cams=2)
    blk = cfg["hetero_fusion"]["hetero_fusion_block"]
    blk.update(input_dim=64, mlp_dim=64, window_size=4, dim_head=16)
    blk["spatial_transform"]["voxel_size"] = [0.64, 0.64, 4.0]
    cfg["hetero_decoder"].update(input_dim=64, num_layer=1, num_ch_dec=[64])
    return cfg


# the stages of a frame: the program's stage mark -> name in the report
MODEL_STAGES = {"lidar": "lidar encoder", "camera": "camera encoder",
                "fusion": "fusion", "decoder": "decoder",
                "decode_nms": "decode + NMS"}


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, edge = 0.0, float("-inf")
    for start, end in sorted(intervals):
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    return busy


def _serving_case(lab: Lab):
    """(config, bf16, request shape, anchors, transform): the production
    bfloat16 server on the card; without one, the rehearsal model in
    float32 on requests at its widths."""
    if lab.dev.type == "cuda":
        cfg, bf16, shape = PROD_CFG, True, {}
    else:
        cfg, bf16 = rehearsal_cfg(), False
        shape = dict(max_points=512, image_size=64, num_cams=2,
                     lidar_range=cfg["lidar"]["lidar_range"])
    anchors = torch.as_tensor(generate_anchor_grid(anchor_args(cfg), "hwl"),
                              dtype=torch.float32, device=lab.dev)
    return cfg, bf16, shape, anchors, torch.eye(4, device=lab.dev)


# the production train step of the root ``bench.py::train_main``
# (tests/test_torch_data.py holds them equal): AdamW at 2e-4 with optax's
# defaults, its dropout key and the anchor targets of its postprocessor
TRAIN_LR, TRAIN_WEIGHT_DECAY, TRAIN_EPS = 2e-4, 1e-4, 1e-8
TRAIN_SEED = 1
TARGET_ARGS = {"pos_threshold": 0.6, "neg_threshold": 0.45,
               "score_threshold": 0.27}


def _train_case(lab: Lab):
    """(state, step, request, labels): ``dict(PROD_CFG, remat=True)``
    with AdamW, the bfloat16 train step (``half=True``) and request 0 in
    numpy with its anchor labels on the card; without one, the rehearsal
    model with the fusion in bfloat16 as in PROD_CFG, on a request at its
    widths."""
    from .postprocess import AnchorPostprocessor
    from .train.trainer import (
        create_train_state,
        labels_for_batch,
        make_train_step,
    )

    if lab.dev.type == "cuda":
        cfg, shape = PROD_CFG, {}
    else:
        cfg = rehearsal_cfg()
        cfg["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"] = \
            PROD_CFG["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"]
        shape = dict(max_points=512, image_size=64, num_cams=2,
                     lidar_range=cfg["lidar"]["lidar_range"])
    cfg = dict(cfg, remat=True)
    request = request_batch(0, **shape)
    pp = AnchorPostprocessor({"anchor_args": anchor_args(cfg),
                              "target_args": TARGET_ARGS, "order": "hwl"})
    labels = labels_for_batch(pp, generate_anchor_grid(anchor_args(cfg)),
                              request, lab.dev)
    model = init_parameters(HMViT(cfg), seed=0).to(lab.dev)
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR,
                            weight_decay=TRAIN_WEIGHT_DECAY, eps=TRAIN_EPS)
    return (create_train_state(model, opt),
            make_train_step(model, opt, half=True), request, labels)


TRACER_FRAMES = 16  # a tracer pass over served frames
# the camera block of the benchmark's ``hmvit_fax_ref`` configuration:
# the released FAX twin at its published widths
FAX_REF_CAMERA = {"encoder": "fax_ref", "dim": 128, "bev_size": 32,
                  "out_dim": 256, "decoder_layers": 2, "img_size": 512,
                  "backbone": "resnet34", "id_pick": [2, 3],
                  "middle": [2, 2], "heads": 4, "dim_head": 32, "window": 4,
                  "bev_range": 100.0}
# the FAX twin's marks inside ``camera``, in the order they run
FAX_MARKS = (tracing.CAMERA_TRUNK, tracing.CAMERA_CROSS_VIEW + "0",
             tracing.CAMERA_CROSS_VIEW + "1", tracing.CAMERA_SELF_ATTN,
             tracing.CAMERA_DECODER)
BUSY_FRAMES = 8  # the profiled frames busy and h2d time are read over
TRACED_STEPS = 2  # the train steps of the traced stretch
PHASES = ("request", "train.forward", "train.backward", "train.optimizer")


def _chrome_trace(prof) -> dict:
    """The profiler's session exported as a chrome trace."""
    from .tools.profile import load_trace

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return load_trace(path)


def _device_ops(trace: dict) -> list[dict]:
    """The kernels, copies and memsets of a chrome trace."""
    from .tools.profile import DEVICE_CATEGORIES

    return [ev for ev in trace.get("traceEvents", [])
            if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES]


def span_table(spans: list[dict], first_unit: int = 0) -> dict:
    """{name: [ms, self ms, syncs]} summed over the spans of the frames or
    steps from ``first_unit`` on (self: less what its child spans
    cover)."""
    table = {}
    for s, own in zip(spans, tracing.self_us(spans)):
        if s["unit"] >= first_unit:
            row = table.setdefault(s["name"], [0.0, 0.0, 0])
            row[0] += (s["end_us"] - s["start_us"]) * 1e-3
            row[1] += own * 1e-3
            row[2] += s["syncs"]
    return table


def idle_by_phase(spans: list[dict], offset_us: float, device: list,
                  first_unit: int = 0, phases=PHASES) -> dict:
    """{phase: device-idle us while it was the outermost open phase span}
    and ``"all"``, every idle us from the first phase span's start to the
    last device operation's end, over the steps from ``first_unit`` on.
    ``offset_us``: the trace's clock less the spans' (the anchor's);
    ``device``: (start, end) us of the device's operations on the
    trace's clock."""
    def outermost(s):
        p = s["parent"]
        while p is not None:
            if spans[p]["name"] in phases:
                return False
            p = spans[p]["parent"]
        return True

    read = [(s["name"], s["start_us"] + offset_us, s["end_us"] + offset_us)
            for s in spans if s["name"] in phases
            and s["unit"] >= first_unit and outermost(s)]
    out = dict.fromkeys(phases, 0.0)
    out["all"] = 0.0
    if not read or not device:
        return out
    edge = min(a for _, a, _ in read)
    for a, b in sorted(device):
        if a > edge:
            out["all"] += a - edge
            for phase, s, e in read:
                out[phase] += max(0.0, min(a, e) - max(edge, s))
        edge = max(edge, b)
    return out


def _on_cost(one, turns, reps: int, sync) -> tuple[float, float]:
    """Median host ms of ``one()`` with the tracer off and on, run in
    ``turns`` ("off" / "on") of ``reps`` calls, the card synchronised
    around each call."""
    ms = {"off": [], "on": []}
    for turn in turns:
        with tracing.on() if turn == "on" else contextlib.nullcontext():
            for i in range(reps):
                sync()
                t0 = time.perf_counter()
                one(i)
                sync()
                ms[turn].append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms["off"])), float(np.median(ms["on"]))


def _table_text(table: dict, per: int, names) -> str:
    return ", ".join(
        f"{name} {table[name][0] / per:.3f} / {table[name][1] / per:.3f} ms"
        f" / {table[name][2] / per:g} syncs" for name in names
        if name in table)


def stage_tracer(lab: Lab):
    """What the program's tracer (:mod:`hmvit_tpu_torch.tracing`) reads
    on the production server and train step, and what it costs."""
    from torch.profiler import ProfilerActivity, profile

    from .graph_server import CompiledServer, _detect

    on_card = lab.dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    cfg, bf16, shape, anchors, eye = _serving_case(lab)
    frames = TRACER_FRAMES if on_card else 2
    batches = [request_batch(seed, **shape) for seed in range(4)]
    hints = serving_hints(batches[0]["mode"][0], 4)
    model = init_parameters(HMViT(serving_config(cfg, bf16=bf16)), seed=0)
    model = (model.to(lab.dev, torch.bfloat16) if bf16
             else model.to(lab.dev)).eval()
    if on_card:
        server = CompiledServer(model, hints, batch_to_device(
            batches[0], lab.dev, bf16), anchors, eye)

        def detect(request):
            return server(request)[1]
    else:  # no graphs without a card: the eager frame they capture
        def detect(request):
            return _detect(model(request, **hints), anchors, eye)

    def frame(i):
        """A served frame: numpy request to boxes on the host."""
        request = batch_to_device(batches[i % len(batches)], lab.dev, bf16)
        return [(c.cpu(), s.cpu(), v.cpu()) for c, s, v in detect(request)]

    for i in range(len(batches)):
        frame(i)
    with tracing.on():  # the traced twin of the bucket is captured
        frame(0)
    sync()
    if on_card:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(BUSY_FRAMES):
                frame(i)
            sync()
        ops = _device_ops(_chrome_trace(prof))
        busy = _busy_us([(ev["ts"], ev["ts"] + ev["dur"]) for ev in ops]) \
            * 1e-3 / BUSY_FRAMES
        h2d = sum(ev["dur"] for ev in ops if ev["cat"] == "gpu_memcpy"
                  and "htod" in ev["name"].lower()) * 1e-3 / BUSY_FRAMES
    with tracing.on() as tracer:
        first = tracer.unit + 1
        for i in range(frames):
            frame(i)
    record = tracer.collect()
    if on_card:
        stages = dict.fromkeys(MODEL_STAGES, 0.0)
        for s in record["stages"]:
            if s["graph"] and s["unit"] >= first:
                stages[s["name"]] += s["ms"] / frames
        total = sum(stages.values())
        lab.report(
            f"tracer [serve] device ms a frame between each stage's marks "
            f"in the replayed graphs, {frames} frames: " + " / ".join(
                f"{name} {ms:.3f}" for name, ms in stages.items())
            + f" (sum {total:.3f}); device busy {busy:.3f} ms and "
            f"host-to-device copies {h2d:.3f} ms a frame over "
            f"{BUSY_FRAMES} profiled frames, tracer off: stages + copies "
            f"= {100.0 * (total + h2d) / busy:.1f}% of busy")
    else:
        lab.report("tracer [serve] graph stage ms: not measured (no "
                   "graphs or device without a card)")
    table = span_table(record["spans"], first)
    counts = {name: sum(s["counts"].get(name, 0) for s in record["spans"]
                        if s["unit"] >= first) / frames
              for name in (tracing.REQUEST_HOST_CAST_BYTES,
                           tracing.REQUEST_PAGEABLE_BYTES)}
    lab.report(f"tracer [serve] spans a frame (ms / self ms / syncs), "
               f"{frames} frames: " + _table_text(
                   table, frames, ("request", "serve.load", "serve.replay",
                                   *MODEL_STAGES))
               + f"; syncs outside any span "
               f"{record['syncs_outside'] / frames:g} a frame; "
               + ", ".join(f"{name} {n:g}" for name, n in counts.items())
               + " a frame")
    off, on = _on_cost(frame, ("off", "on", "on", "off", "off", "on"),
                       len(batches), sync)
    lab.report(f"tracer [serve] a frame, request to boxes on the host "
               f"(host clock): median {off:.3f} ms tracer off, {on:.3f} ms "
               f"on ({100.0 * (on / off - 1):+.1f}%), turns off / on / on "
               f"/ off / off / on of {len(batches)} frames")
    del model, detect, frame
    if on_card:
        del server
        torch.cuda.empty_cache()

    with torch.enable_grad():
        state, step, batch, labels = _train_case(lab)

        def one(_=0):
            step(state, batch_to_device(batch, lab.dev, False), labels,
                 TRAIN_SEED)

        for _ in range(2):
            one()
        off, on = _on_cost(one, ("off", "on", "on", "off"),
                           min(lab.iters, 5), sync)
        lab.report(f"tracer [train] a step, numpy request to the update "
                   f"(host clock, no profiler): median {off:.3f} ms tracer "
                   f"off, {on:.3f} ms on ({100.0 * (on / off - 1):+.1f}%), "
                   f"turns off / on / on / off of {min(lab.iters, 5)} steps")
        profiler = (profile(activities=[ProfilerActivity.CUDA]) if on_card
                    else contextlib.nullcontext())
        with tracing.on() as tracer, profiler as prof:
            one()  # not read: a session's first kernels can miss its trace
            sync()
            first = tracer.unit + 1
            t0 = time.perf_counter()
            for _ in range(TRACED_STEPS):
                one()
            sync()
            wall = (time.perf_counter() - t0) * 1e3 / TRACED_STEPS
            tracing.anchor()
    record = tracer.collect()
    if on_card:
        trace = _chrome_trace(prof)
        offset = tracing.trace_offset_us(trace, record["anchors"][0])
        idle = idle_by_phase(
            record["spans"], offset,
            [(ev["ts"], ev["ts"] + ev["dur"]) for ev in _device_ops(trace)],
            first)
        covered = sum(idle[p] for p in PHASES)
        lab.report(
            f"tracer [train] device-idle ms a step by the outermost phase "
            f"open, device-only trace of {TRACED_STEPS} steps with the "
            f"tracer on ({wall:.3f} ms a step): " + " / ".join(
                f"{p} {idle[p] * 1e-3 / TRACED_STEPS:.3f}" for p in PHASES)
            + f" of {idle['all'] * 1e-3 / TRACED_STEPS:.3f} idle "
            f"({100.0 * covered / max(idle['all'], 1e-9):.1f}% covered)")
    else:
        lab.report("tracer [train] device-idle ms by phase: not measured "
                   "(no device trace without a card)")
    table = span_table(record["spans"], first)
    lab.report(f"tracer [train] spans a step (ms / self ms / syncs), "
               f"{TRACED_STEPS} steps: " + _table_text(
                   table, TRACED_STEPS, PHASES)
               + f"; syncs outside any span {record['syncs_outside']:g}")
    del state, step
    if on_card:
        torch.cuda.empty_cache()
    _fax_tracer(lab)


def _fax_tracer(lab: Lab):
    """The FAX twin's sub-stages on a fleet of 4 camera agents (the
    production model with :data:`FAX_REF_CAMERA`; here its rehearsal
    widths): the device ms a replayed frame between each of
    :data:`FAX_MARKS` against the ``camera`` mark, then an eager pass's
    spans, syncs and ``fax.score_elems`` a frame."""
    from .graph_server import CompiledServer

    on_card = lab.dev.type == "cuda"
    cfg, bf16, shape, anchors, eye = _serving_case(lab)
    camera = (FAX_REF_CAMERA if on_card else
              dict(FAX_REF_CAMERA, dim=32, bev_size=4, out_dim=64, heads=2,
                   dim_head=16))
    batches = [request_batch(seed, **shape) for seed in range(4)]
    for b in batches:
        b["mode"][:, :4] = 0  # every agent a camera rig, the ego too
    hints = serving_hints(batches[0]["mode"][0], 4)
    model = init_parameters(
        HMViT(serving_config(dict(cfg, camera=camera), bf16=bf16)), seed=0)
    model = (model.to(lab.dev, torch.bfloat16) if bf16
             else model.to(lab.dev)).eval().requires_grad_(False)

    def request(i):
        return batch_to_device(batches[i % len(batches)], lab.dev, bf16)

    if on_card:
        frames = TRACER_FRAMES
        server = CompiledServer(model, hints, request(0), anchors, eye)
        for i in range(len(batches)):
            server(request(i))
        with tracing.on():  # the traced twin of the bucket is captured
            server(request(0))
        with tracing.on() as tracer:
            first = tracer.unit + 1
            for i in range(frames):
                server(request(i))
        ms = {}
        for s in tracer.collect()["stages"]:
            if s["graph"] and s["unit"] >= first:
                ms[s["name"]] = ms.get(s["name"], 0.0) + s["ms"] / frames
        total = sum(ms[name] for name in FAX_MARKS)
        lab.report(
            f"tracer [serve fax_ref] device ms a frame between each mark in "
            f"the replayed graphs, {frames} frames of 4 camera agents: "
            f"camera {ms['camera']:.3f} = " + " / ".join(
                f"{name} {ms[name]:.3f}" for name in FAX_MARKS)
            + f" (sum {total:.3f}, {100.0 * total / ms['camera']:.1f}% of "
            f"camera); fusion {ms['fusion']:.3f}, decoder "
            f"{ms['decoder']:.3f}, decode_nms {ms['decode_nms']:.3f}")
        del server
    else:
        lab.report("tracer [serve fax_ref] graph sub-stage ms: not measured "
                   "(no graphs or device without a card)")
    eager = 2
    with torch.no_grad():
        model(request(0), **hints)  # the grids and device constants made
        with tracing.on() as tracer:
            first = tracer.unit + 1
            for i in range(eager):
                model(request(i), **hints)
            if on_card:
                torch.cuda.synchronize()
    spans = [s for s in tracer.collect()["spans"] if s["unit"] >= first]
    elems = sum(s["counts"].get(tracing.FAX_SCORE_ELEMS, 0)
                for s in spans) / eager
    lab.report(f"tracer [serve fax_ref] eager spans a frame (ms / self ms / "
               f"syncs), {eager} frames: " + _table_text(
                   span_table(spans), eager, ("camera", *FAX_MARKS))
               + f"; {tracing.FAX_SCORE_ELEMS} {elems:g} a frame")
    del model
    if on_card:
        torch.cuda.empty_cache()



STAGES = {
    "attn": lambda lab: [stage_attn_typed(lab, dtype)
                         for dtype in (torch.float32, torch.bfloat16)],
    "pairwarp": lambda lab: [stage_pairwarp(lab, torch.bfloat16, l)
                             for l in (4, 5)],
    "pairwarp_res": lambda lab: [stage_pairwarp_res(lab, l, r)
                                 for l, r in ((4, None), (5, None), (4, 1))]
    + [stage_pairwarp_res_window(lab)],
    "fused_wa": lambda lab: [stage_fused_wa(lab, torch.bfloat16, l, r)
                             for l, r in ((4, None), (4, 1), (5, None))],
    "segscan": stage_segscan,
    "expand": stage_expand,
    "lidar": stage_lidar,
    "tracer": stage_tracer,
}


def run_stages(names, device, iters: int = 20, shapes: Shapes = PROD):
    """Run the named stages (all when empty) on ``device``."""
    lab = Lab(device, shapes, iters)
    for name in names or list(STAGES):
        if name not in STAGES:
            raise ValueError(f"unknown stage {name!r}; stages: "
                             f"{sorted(STAGES)}")
        with torch.no_grad():
            STAGES[name](lab)
        if lab.dev.type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", help=f"of {sorted(STAGES)}")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at a tiny size (plain twins)")
    args = ap.parse_args(argv)
    if args.cpu:
        run_stages(args.stages, "cpu", args.iters, TINY)
        return 0
    if not torch.cuda.is_available():
        print("perf_lab: no CUDA device (pass --cpu for a CPU rehearsal)",
              file=sys.stderr)
        return 2
    run_stages(args.stages, "cuda:0", args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
