"""Benchmark of the port: HM-ViT 4-agent mixed-modality inference,
frames/sec/chip on one NVIDIA GPU (the port of ``bench.py::main``), or
training steps/sec/chip with ``--train`` (``bench.py::train_main``).

    python -m hmvit_tpu_torch.bench [--fp32] [--batch N] [--no_stripe]
        [--fused_wa] [--expand v1|v2] [--stem_s2d] [--iters N] [--cpu]
    python -m hmvit_tpu_torch.bench --train [--no_remat]
        [--remat_stages a,b] [--batch N] [--bucketed] [--stem_s2d]
        [--iters N] [--cpu]

The production model (:data:`hmvit_tpu_torch.serving.PROD_CFG`: lidar
range +-102.4 m, 0.4 m voxels -> 512^2 pillar grid, 4 x 512^2 camera
images per camera agent, 128^2 x 256 BEV fusion, window 8, 2 H3GAT
iterations), random weights from seed 0, the request ``bench.py`` builds
(seed 0, 4 agents alternating lidar / camera in 5 slots) with its bf16
casts and serving hints.  ``--stem_s2d`` runs the camera trunk's stem
as the space-to-depth convolution (the same weights and function,
``models/resnet.py::s2d_stem``).  The forward is captured once in a CUDA graph
(:class:`hmvit_tpu_torch.graph_server.CompiledServer`, the port's
``jax.jit``) and replayed ``--iters`` times back to back, with one
``torch.cuda.synchronize()`` at the end: fps = batch x iters / dt.
Prints ONE JSON line with ``bench.py``'s keys, plus ``ms_per_frame``.

``flops_per_frame`` is ``FlopCounterMode``'s count over one eager
forward plus the hand-written kernels' operation counts
(:mod:`hmvit_tpu_torch.ops.opcount`), which the counter cannot see;
``mfu`` is it at the measured fps over the card's dense bf16 peak
(:data:`PEAK_BF16_FLOPS`).  With ``BENCH_TRACE_DIR`` set, 4 replays run
under ``torch.profiler`` and the chrome trace goes to that directory,
for ``python -m hmvit_tpu_torch.tools.profile``.

``--train`` runs the production training step of ``bench.py``: the same
request (seed 0) with its anchor labels, ``dict(PROD_CFG, remat=True)``
(``--no_remat``: none; ``--remat_stages camera,fusion``: those), the
run-both trace (``--bucketed``: the step bucketed on the camera count),
AdamW at 2e-4 with optax's defaults (weight decay 1e-4, eps 1e-8),
``half=True`` (bfloat16 compute against float32 masters), dropout seed
1.  One warm step, then ``--iters`` (10) steps back to back with one
synchronise at the end.  It prints ``bench.py``'s training keys:
steps/s, ``frames_per_sec``, ``flops_per_step`` (``FlopCounterMode`` over
one step, the backward, the remat recomputes and the plain twins'
backward recompute included, plus the kernels' operation counts of
every launch, the recompute's too), ``train_mfu`` and ``hbm_peak_gb``
(``torch.cuda.max_memory_allocated``).  With ``BENCH_TRACE_DIR`` set,
one more step runs under ``torch.profiler``.

Without a CUDA device it exits 2.  ``--cpu`` is an eager rehearsal of
the same flow on the kernels' plain twins at a tiny size: its times are
not device times, and its record says so.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

# the port's copies of bench.py's constants (tests/test_torch_data.py
# holds them equal): the assumed reference pipeline's frames/sec, and
# the metric's name
ASSUMED_REFERENCE_FPS = 2.5
METRIC = "frames/sec/chip 4-agent mixed-modality BEV inference"
TRAIN_METRIC = "train steps/sec/chip 4-agent mixed-modality"

# bench.py::train_main's optimizer: optax.adamw(2e-4), its defaults
TRAIN_LR, TRAIN_WEIGHT_DECAY, TRAIN_EPS = 2e-4, 1e-4, 1e-8
TRAIN_ITERS = 10
TRAIN_SEED = 1  # bench.py's dropout key, jax.random.key(1)
# the anchor targets of bench.py::train_main's postprocessor
TARGET_ARGS = {"pos_threshold": 0.6, "neg_threshold": 0.45,
               "score_threshold": 0.27}

# dense bf16 peak of one card (NVIDIA's data sheets) keyed by a prefix of
# torch.cuda.get_device_name(), in bench.py's table shape
PEAK_BF16_FLOPS = (
    ("NVIDIA H100 80GB HBM3", 989e12),  # H100 SXM
    ("NVIDIA H100 PCIe", 756e12),
)

NUM_AGENTS = 4
TRACED_REPLAYS = 4
CPU_NOTE = "cpu rehearsal, plain twins, eager: not a device time"


def peak_bf16_flops(device_name: str) -> float | None:
    for prefix, peak in PEAK_BF16_FLOPS:
        if device_name.startswith(prefix):
            return peak
    return None


def build(args, device):
    """(model, request, hints, anchors): the served variant, the request
    on ``device`` and its static hints."""
    from .data.anchors import generate_anchor_grid
    from .models.hmvit import HMViT
    from .nn import init_parameters
    from .serving import (
        PROD_CFG,
        anchor_args,
        batch_to_device,
        request_batch,
        serving_config,
        serving_hints,
    )

    bf16 = not args.fp32
    if args.cpu:
        from .perf_lab import rehearsal_cfg

        base = rehearsal_cfg()
        shape = dict(max_points=512, image_size=64, num_cams=2,
                     lidar_range=base["lidar"]["lidar_range"])
    else:
        base, shape = PROD_CFG, {}
    cfg = serving_config(base, bf16=bf16, fused_wa=args.fused_wa,
                         stripe=not args.no_stripe, expand=args.expand)
    cfg["camera"]["stem_s2d"] = args.stem_s2d
    model = init_parameters(HMViT(cfg), seed=0)
    model = (model.to(device, torch.bfloat16) if bf16
             else model.to(device)).eval().requires_grad_(False)
    batch = request_batch(0, num_agents=NUM_AGENTS, batch_size=args.batch,
                          **shape)
    hints = serving_hints(batch["mode"][0], NUM_AGENTS, args.batch)
    anchors = torch.as_tensor(generate_anchor_grid(anchor_args(cfg), "hwl"),
                              dtype=torch.float32, device=device)
    return model, batch_to_device(batch, device, bf16), hints, anchors


def count_flops(model, request, hints) -> tuple[float, float]:
    """(counter FLOPs, kernel operations) of one eager forward: what
    ``FlopCounterMode`` counts (matrix products, convolutions) and what
    the hand-written kernels do (their formulas; the counter cannot see
    a ctypes launch, and the plain twins that stand in for them on CPU
    tensors are hidden from it).  The model's parameters must not
    require grad, as :func:`build` leaves them: the counter's module
    tracker hooks autograd."""
    from .ops.opcount import flop_counter, record_kernel_ops

    counter = flop_counter()
    with torch.no_grad(), counter, record_kernel_ops() as calls:
        model(request, **hints)
    return float(counter.get_total_flops()), sum(ops for _, ops in calls)


def train_config(args) -> dict:
    """``dict(PROD_CFG, remat=...)`` (``--cpu``: its structure at the
    rehearsal widths, the fusion in bfloat16 as in PROD_CFG)."""
    import copy

    from .serving import PROD_CFG

    if args.cpu:
        from .perf_lab import rehearsal_cfg

        cfg = rehearsal_cfg()
        cfg["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"] = \
            PROD_CFG["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"]
    else:
        cfg = copy.deepcopy(PROD_CFG)
    cfg["camera"]["stem_s2d"] = args.stem_s2d
    remat = True
    if args.no_remat:
        remat = False
    if args.remat_stages:
        remat = args.remat_stages.split(",")
    return dict(cfg, remat=remat)


def build_train(args, device):
    """(state, step, batch, labels): the training bench's model, AdamW,
    train step and the request with its anchor labels on ``device``."""
    from .data.anchors import generate_anchor_grid
    from .models.hmvit import HMViT
    from .nn import init_parameters
    from .postprocess import AnchorPostprocessor
    from .serving import anchor_args, batch_to_device, request_batch
    from .train.trainer import (
        create_train_state,
        labels_for_batch,
        make_bucketed_train_step,
        make_train_step,
    )

    cfg = train_config(args)
    shape = (dict(max_points=512, image_size=64, num_cams=2,
                  lidar_range=cfg["lidar"]["lidar_range"]) if args.cpu
             else {})
    batch = request_batch(0, num_agents=NUM_AGENTS, batch_size=args.batch,
                          **shape)
    pp = AnchorPostprocessor({"anchor_args": anchor_args(cfg),
                              "target_args": TARGET_ARGS, "order": "hwl"})
    labels = labels_for_batch(pp, generate_anchor_grid(anchor_args(cfg)),
                              batch, device)
    model = init_parameters(HMViT(cfg), seed=0).to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=TRAIN_LR,
                            weight_decay=TRAIN_WEIGHT_DECAY, eps=TRAIN_EPS)
    make = make_bucketed_train_step if args.bucketed else make_train_step
    step = make(model, opt, half=True)
    return (create_train_state(model, opt), step,
            batch_to_device(batch, device, bf16=False), labels)


def count_train_flops(state, step, batch, labels) -> tuple[float, float]:
    """(counter FLOPs, kernel operations) of one train step: the counter
    sees the forward's library calls, the backward, the remat recomputes
    and the plain twins' backward recompute; the kernels' formulas count
    every launch, the remat recompute's too."""
    from .ops.opcount import flop_counter, record_kernel_ops

    counter = flop_counter()
    with counter, record_kernel_ops() as calls:
        step(state, batch, labels, TRAIN_SEED)
    return float(counter.get_total_flops()), sum(ops for _, ops in calls)


def run_train(args) -> dict:
    """Build, warm, time ``--iters`` train steps, count; the record."""
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    state, step, batch, labels = build_train(args, device)
    sync = (lambda: None) if args.cpu else torch.cuda.synchronize  # noqa
    if not args.cpu:
        torch.cuda.reset_peak_memory_stats()
    state, parts = step(state, batch, labels, TRAIN_SEED)  # warm
    first_loss = float(parts["total_loss"])
    iters = TRAIN_ITERS if args.iters is None else args.iters
    t0 = time.perf_counter()
    for _ in range(iters):
        state, parts = step(state, batch, labels, TRAIN_SEED)
    sync()
    dt = time.perf_counter() - t0
    last_loss = float(parts["total_loss"])
    steps_per_sec = iters / dt
    peak = None if args.cpu else torch.cuda.max_memory_allocated() / 2 ** 30
    trace_dir = os.environ.get("BENCH_TRACE_DIR", "")
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if not args.cpu:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            step(state, batch, labels, TRAIN_SEED)
            sync()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "train_trace.json"))
    counted, kernel_ops = count_train_flops(state, step, batch, labels)
    flops = counted + kernel_ops
    remat = state.model.config["remat"]
    record = {
        "metric": TRAIN_METRIC + " (bf16 AMP, AdamW, remat=%s, batch=%d%s)"
        % (remat, args.batch, ", count-bucketed" if args.bucketed else ""),
        "value": round(steps_per_sec, 3),
        "unit": "steps/sec/chip",
        "frames_per_sec": round(steps_per_sec * args.batch, 3),
        "vs_baseline": None,
        "flops_per_step": round(flops / 1e9, 2),
        "flops_unit": "GFLOP/step",
        "kernel_gflops_per_step": round(kernel_ops / 1e9, 2),
        "train_mfu": None,
        "hbm_peak_gb": None if peak is None else round(peak, 2),
        "loss_first_last": [first_loss, last_loss],
        "device_kind": "cpu",
    }
    if args.cpu:
        record["note"] = CPU_NOTE
    else:
        kind = torch.cuda.get_device_name(0)
        peak_flops = peak_bf16_flops(kind)
        record.update(device_kind=kind, card=card_line(),
                      train_mfu=(round(steps_per_sec * flops / peak_flops, 4)
                                 if peak_flops else None),
                      timed=f"{iters} train steps, one synchronise")
    return record


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def run(args) -> dict:
    """Build, capture, count, trace if asked, time; the JSON record."""
    device = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    model, request, hints, anchors = build(args, device)
    if args.cpu:
        def forward():
            with torch.no_grad():
                return model(request, **hints)
        sync = lambda: None  # noqa: E731
    else:
        from .graph_server import CompiledServer

        server = CompiledServer(model, hints, request, anchors,
                                torch.eye(4, device=device))
        bucket = server.load(request)

        def forward():
            return server.replay_forward(bucket)
        sync = torch.cuda.synchronize
    forward()
    sync()
    trace_dir = os.environ.get("BENCH_TRACE_DIR", "")
    if trace_dir:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if not args.cpu:
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            for _ in range(TRACED_REPLAYS):
                forward()
            sync()
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "bench_trace.json"))
    t0 = time.perf_counter()
    iters = 20 if args.iters is None else args.iters
    for _ in range(iters):
        forward()
    sync()
    dt = time.perf_counter() - t0
    fps = args.batch * iters / dt
    counted, kernel_ops = count_flops(model, request, hints)
    flops_per_frame = (counted + kernel_ops) / args.batch
    tag = "" if args.batch == 1 else f" (serving batch {args.batch})"
    record = {
        "metric": METRIC + tag,
        "value": round(fps, 3),
        "unit": "frames/sec/chip",
        "vs_baseline": round(fps / ASSUMED_REFERENCE_FPS, 3),
        "flops_per_frame": round(flops_per_frame / 1e9, 2),
        "flops_unit": "GFLOP/frame",
        "mfu": None,
        "device_kind": "cpu",
        "ms_per_frame": 1e3 / fps,
    }
    if args.cpu:
        record["note"] = CPU_NOTE
    else:
        kind = torch.cuda.get_device_name(0)
        peak = peak_bf16_flops(kind)
        record.update(device_kind=kind, card=card_line(),
                      mfu=(round(flops_per_frame * fps / peak, 4) if peak
                           else None),
                      timed="CUDA graph replays of the forward",
                      replays=server.replays)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fp32", action="store_true",
                    help="float32 weights and compute (default bf16)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--no_stripe", action="store_true",
                    help="local phases by window split + plain attention")
    ap.add_argument("--fused_wa", action="store_true",
                    help="local phases in the fused warp + attention kernel")
    ap.add_argument("--expand", choices=("v1", "v2"), default=None,
                    help="the lidar dense grid by an expansion kernel")
    ap.add_argument("--stem_s2d", action="store_true",
                    help="the camera stem as the space-to-depth conv")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed forwards (default 20) or train steps (10)")
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at a tiny size (plain twins)")
    ap.add_argument("--train", action="store_true",
                    help="training steps/sec instead of serving frames/sec")
    ap.add_argument("--no_remat", action="store_true",
                    help="--train: no gradient checkpointing")
    ap.add_argument("--remat_stages", default=None,
                    help="--train: checkpoint only these stages, e.g. "
                         "camera,fusion")
    ap.add_argument("--bucketed", action="store_true",
                    help="--train: the step bucketed on the camera count")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --cpu for a CPU rehearsal)",
              file=sys.stderr)
        return 2
    print(json.dumps(run_train(args) if args.train else run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
