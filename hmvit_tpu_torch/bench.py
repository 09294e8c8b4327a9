"""Benchmark of the port: HM-ViT 4-agent mixed-modality inference,
frames/sec/chip on one NVIDIA GPU (the port of ``bench.py::main``).

    python -m hmvit_tpu_torch.bench [--fp32] [--batch N] [--no_stripe]
        [--fused_wa] [--expand v1|v2] [--iters N] [--cpu]

The production model (:data:`hmvit_tpu_torch.serving.PROD_CFG`: lidar
range +-102.4 m, 0.4 m voxels -> 512^2 pillar grid, 4 x 512^2 camera
images per camera agent, 128^2 x 256 BEV fusion, window 8, 2 H3GAT
iterations), random weights from seed 0, the request ``bench.py`` builds
(seed 0, 4 agents alternating lidar / camera in 5 slots) with its bf16
casts and serving hints.  The forward is captured once in a CUDA graph
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


def refused(flag: str) -> str | None:
    """Why a flag of ``bench.py`` is not served here, or None."""
    return {"--stem_s2d": "the space-to-depth camera stem is not ported "
                          "(ROADMAP.md Queue 1 item 7)",
            "--train": "training is not ported (ROADMAP.md Queue 1 item 3)",
            }.get(flag)


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
    from torch.utils.flop_counter import FlopCounterMode

    from .ops.opcount import record_kernel_ops

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter, record_kernel_ops() as calls:
        model(request, **hints)
    return float(counter.get_total_flops()), sum(ops for _, ops in calls)


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
    for _ in range(args.iters):
        forward()
    sync()
    dt = time.perf_counter() - t0
    fps = args.batch * args.iters / dt
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
    argv = list(sys.argv[1:] if argv is None else argv)
    for flag in ("--stem_s2d", "--train"):
        if flag in argv:
            print(f"bench: {flag}: {refused(flag)}", file=sys.stderr)
            return 2
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
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at a tiny size (plain twins)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("bench: no CUDA device (pass --cpu for a CPU rehearsal)",
              file=sys.stderr)
        return 2
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
