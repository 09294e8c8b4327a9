"""The serve runner: one client, one request in flight (a closed loop), each
frame from its numpy request to its boxes on the host through the port's
serving path: ``serving.batch_to_device`` -> ``CompiledServer`` (the
forward graph, then the decode + NMS graph) -> the boxes read back.

Set-up builds the served model from the configuration with the
benchmark's seeded weights (bf16, on the card), draws the cell's pool of
requests, captures the cell's one bucket and sends every request of the
pool once.  The window then cycles through the pool for ``seconds``;
``frames_per_s`` is the frames completed over the window's time and
``frame_p95_ms`` the 95th percentile of every frame's latency.  A sample
of the frames, drawn from the seed among the pool's first passes, keeps
its outputs for the comparison after the window (frames the window did
not reach are served after it, untimed, so every sampled frame is
compared).  With ``trace`` the window is followed by a
traced stretch of served frames and by an eager traced pass over the
pool with the benchmark's stage ranges, which the per-layer metrics
read."""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import compare, generator, trace as tr
from .weights import float_shapes, load, make_weights

TRACED_FRAMES = 8
STAGE_FRAMES = 4
# the stages the forward hooks mark: HMViT attribute -> range name
STAGES = {"lidar_encoder": "lidar", "camera_encoder": "camera",
          "fusion": "fusion", "HeteroDecoder_0": "decoder"}
# tensor arguments of a kernel launch small enough to keep with its
# record (per-launch tables such as the pair warp's receiver types)
SMALL_BYTES = 1 << 16


def sample_frames(seed: int, traffic: dict) -> set[int]:
    """The timed frames whose outputs are compared: for each request of
    the pool, one of its first ``cycles`` passes, drawn from the seed."""
    pool, cycles = traffic["pool"], traffic["compare_cycles"]
    rng = np.random.default_rng([int(seed), 1 << 20])
    return {int(c) * pool + i
            for i, c in enumerate(rng.integers(0, cycles, pool))}


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of every value, linear between ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


class Server:
    """The port's served model and graph server for one cell."""

    def __init__(self, config, traffic, seed, device):
        from hmvit_tpu_torch.data.anchors import generate_anchor_grid
        from hmvit_tpu_torch.graph_server import CompiledServer
        from hmvit_tpu_torch.models.hmvit import HMViT
        from hmvit_tpu_torch.serving import batch_to_device, serving_config

        self.device = device
        self.to_device = batch_to_device
        cfg = serving_config(config["model"], bf16=True)
        model = HMViT(cfg).to(device, torch.bfloat16)
        load(model, make_weights(float_shapes(model), seed, device,
                                 torch.bfloat16))
        self.model = model.eval().requires_grad_(False)
        self.hints = compare.hints(traffic)
        self.anchors = torch.as_tensor(
            generate_anchor_grid(config["anchor_args"], "hwl"),
            dtype=torch.float32, device=device)
        self.eye = torch.eye(4, device=device)
        self.pool = generator.make_pool(seed, traffic)
        self.server = CompiledServer(
            self.model, self.hints, self.request(0), self.anchors, self.eye)

    def request(self, index: int) -> dict:
        return self.to_device(self.pool[index], self.device, True)

    def frame(self, index: int):
        """One served frame: the request to the card, both graphs, the
        boxes to the host.  Returns the graph's outputs (static tensors)
        and the boxes."""
        out, det = self.server(self.request(index), self.hints)
        boxes = [(c.cpu(), s.cpu(), v.cpu()) for c, s, v in det]
        return out, det, boxes


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device) -> dict:
    config, traffic = spec["config"], spec["traffic"]
    srv = Server(config, traffic, seed, device)
    pool = len(srv.pool)
    for i in range(pool):  # every request once: copies and graphs warm
        srv.frame(i)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    sample = sample_frames(seed, traffic)
    kept, lat = [], []

    def keep(k, out, det):
        if k in sample:
            (c, s, v), = det
            kept.append((k % pool, out["psm"].clone(), out["rm"].clone(),
                         c.clone(), s.clone(), v.clone()))

    t0 = time.perf_counter()
    k = 0
    while True:
        f0 = time.perf_counter()
        if f0 - t0 >= seconds:
            break
        out, det, _ = srv.frame(k % pool)
        lat.append(time.perf_counter() - f0)
        keep(k, out, det)
        k += 1
    window_s = time.perf_counter() - t0
    frames = len(lat)
    while k <= max(sample):  # sampled frames the window did not reach
        out, det, _ = srv.frame(k % pool)
        keep(k, out, det)
        k += 1
    torch.cuda.synchronize()
    result = {
        "attempted": frames, "failed": 0, "setup_s": setup_s,
        "end_to_end": {"frames_per_s": frames / window_s,
                       "frame_p95_ms": 1e3 * percentile(lat, 95)},
        "stderr": [f"window {window_s:.3f} s, {frames} frames, latency "
                   f"p50 {1e3 * statistics.median(lat):.3f} ms, p95 "
                   f"{1e3 * percentile(lat, 95):.3f} ms, max "
                   f"{1e3 * max(lat):.3f} ms"]}
    ctx = None
    if trace:
        ctx = traced(srv, spec, frames / window_s)
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    requests = srv.pool
    del srv
    torch.cuda.empty_cache()
    if ctx is not None:
        ctx["flops"] = reference_flops(config, traffic, seed, requests,
                                       device)
    result["ctx"] = ctx
    result["compared"] = compare.serve_numbers(kept, requests, config,
                                               traffic, seed, device)
    return result


def traced(srv: Server, spec: dict, rate: float) -> dict:
    """The traced stretch: ``TRACED_FRAMES`` served frames under the
    profiler, then an eager pass over ``STAGE_FRAMES`` requests with the
    stage ranges, which also records the kernels' launch arguments."""
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.postprocess import decode_detections_device

    pool = len(srv.pool)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for k in range(TRACED_FRAMES):
            with record_function("bench_frame"):
                srv.frame(k % pool)
    graph = tr.Trace(tr.export(prof))
    frames = graph.annotations("bench_frame")
    lo = frames[0]["ts"]
    hi = frames[-1]["ts"] + frames[-1]["dur"]
    busy = tr.busy_us(graph.device_in(lo, hi), lo, hi)

    launches = {name: [] for name in cuda.KERNELS}

    def recorder(name, kernel):
        original = kernel.launch

        def launch(tensors, ints, key=None):
            small = {i: t.clone() for i, t in enumerate(tensors)
                     if t.numel() * t.element_size() <= SMALL_BYTES}
            launches[name].append({"ints": [int(i) for i in ints],
                                   "small": small})
            return original(tensors, ints, key)
        return launch

    hooks = []
    for attr, stage in STAGES.items():
        module = getattr(srv.model, attr)
        span = {}

        def enter(m, args, kwargs, stage=stage, span=span):
            span["r"] = record_function("stage: " + stage)
            span["r"].__enter__()

        def leave(m, args, out, span=span):
            span.pop("r").__exit__(None, None, None)
        hooks += [module.register_forward_pre_hook(enter, with_kwargs=True),
                  module.register_forward_hook(leave)]
    with torch.no_grad():  # one eager frame outside the trace: warm paths
        srv.model(srv.request(0), **srv.hints)
    for name, kernel in cuda.KERNELS.items():
        kernel.launch = recorder(name, kernel)
    try:
        with profile(activities=acts) as prof, torch.no_grad():
            for k in range(STAGE_FRAMES):
                req = srv.request(k % pool)
                if k == 1:  # the launches of one frame are recorded
                    for kernel in cuda.KERNELS.values():
                        vars(kernel).pop("launch", None)
                out = srv.model(req, **srv.hints)
                with record_function("stage: decode_nms"):
                    decode_detections_device(out["psm"], out["rm"],
                                             srv.anchors, srv.eye)
            torch.cuda.synchronize()
    finally:
        for kernel in cuda.KERNELS.values():
            vars(kernel).pop("launch", None)
        for h in hooks:
            h.remove()
    for records in launches.values():
        for r in records:
            r["small"] = {i: t.cpu() for i, t in r["small"].items()}
    eager = tr.Trace(tr.export(prof))
    return {"kind": "serve", "trace": graph,
            "traced_frames": [(k % pool, ev) for k, ev in enumerate(frames)],
            "window_s": (hi - lo) * 1e-6, "busy_s": busy * 1e-6,
            "stage_ranges": eager.launched_inside("stage: "),
            "stage_frames": STAGE_FRAMES, "launches": launches,
            "pool": srv.pool, "rate": rate, "config": spec["config"],
            "breakdown": {"device_ops": tr.top_ops(graph.device_in(lo, hi)),
                          "idle_gaps": tr.idle_gaps(graph, lo, hi)},
            "classes": tr.by_class(graph.device_in(lo, hi))}


def reference_flops(config, traffic, seed, pool, device) -> float:
    """FLOPs of one frame on the reference: ``FlopCounterMode`` over its
    forward (matrix products, convolutions) plus its copies' formulas for
    the plain warp and window attention, whose einsums the counter does
    not see there."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.ops.opcount import record_kernel_ops

    with compare.strict_fp32(), torch.no_grad():
        ref = compare.reference_model(config["model"], seed,
                                      device).requires_grad_(False)
        counter = FlopCounterMode(display=False)
        with counter, record_kernel_ops() as calls:
            ref(compare.to_device(pool[0], device), **compare.hints(traffic))
    flops = float(counter.get_total_flops()) + sum(o for _, o in calls)
    del ref
    torch.cuda.empty_cache()
    return flops
