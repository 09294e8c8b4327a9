"""Performance report of a run directory (port of
``hmvit_tpu/tools/performance.py``): the model's parameter count, its
FLOPs a frame and its eager frames per second on the first validation
frame, as one JSON line.

FLOPs are ``FlopCounterMode``'s count over one forward (matrix products
and convolutions) plus the hand-written kernels' operation counts
(:mod:`hmvit_tpu_torch.ops.opcount`); a multiply-add is 2.
``measure_fps`` times ``--iters`` forwards after one warm-up, between
two ``torch.cuda.synchronize`` calls on the card.  ``--trace_dir`` writes
a ``torch.profiler`` chrome trace of one forward there, which
``python -m hmvit_tpu_torch.tools.profile <trace_dir>`` reads.

    python -m hmvit_tpu_torch.tools.performance --model_dir runs/<run>
        [--synthetic] [--iters N] [--trace_dir d] [--cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time


def count_params(model) -> int:
    return sum(p.numel() for p in model.parameters())


def count_flops(model, batch) -> float:
    """FLOPs of one eager forward: the counter's and the kernels'."""
    import torch

    from ..ops.opcount import flop_counter, record_kernel_ops

    counter = flop_counter()
    with torch.no_grad(), counter, record_kernel_ops() as calls:
        model(batch)
    return float(counter.get_total_flops()) + sum(ops for _, ops in calls)


def measure_fps(fn, args, iters: int = 10, sync=None) -> float:
    sync = sync or (lambda: None)
    fn(*args)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync()
    return iters / (time.perf_counter() - t0)


def main(argv=None):
    p = argparse.ArgumentParser("hmvit_tpu_torch performance runner")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--max_points", type=int, default=30000)
    p.add_argument("--trace_dir", default="")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain twins)")
    args = p.parse_args(argv)

    import torch

    from ..config import load_config
    from ..data.opv2v import HeteroCooperativeDataset
    from .common import device_of, load_runnable, to_device, \
        write_synthetic

    dev = device_of(args.cpu, "tools.performance")
    params = load_config("", model_dir=args.model_dir)
    if args.synthetic:
        write_synthetic(params, "mini_opv2v_perf_", args.max_points,
                        num_scenarios=1, num_cavs=2, num_frames=2)
    dataset = HeteroCooperativeDataset(params, train=False,
                                       max_points=args.max_points)
    batch = to_device(dataset.collate_batch([dataset[0]]), dev)
    model, _ = load_runnable(args.model_dir, dev)
    model.requires_grad_(False)  # the counter's module tracker hooks autograd

    def forward(b):
        with torch.no_grad():
            return model(b)

    n_params = count_params(model)
    flops = count_flops(model, batch)
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            forward(batch)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace_dir,
                                              "performance_trace.json"))
    sync = torch.cuda.synchronize if dev.type == "cuda" else None
    fps = measure_fps(forward, (batch,), iters=args.iters, sync=sync)
    report = {
        "params": n_params,
        "params_million": round(n_params / 1e6, 3),
        "flops_per_frame": flops,
        "gmacs": round(flops / 2e9, 2) if flops else None,
        "fps": round(fps, 3),
        "device": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
