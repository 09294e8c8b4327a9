#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port of the HM-ViT serving path.

Run from the root of a checkout on a machine with one NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases:

1. require CUDA; print the card's name and power limit; build the CUDA
   kernels from ``hmvit_tpu_torch/csrc`` (nvcc, sm_90a) and time it;
2. check every kernel against its plain PyTorch twin on the card at the
   serving shapes, in float32 (tight) and bfloat16 (stated tolerance),
   and time, in bfloat16, the kernel launch alone, the whole wrapper and
   the twin (CUDA events, median of 20 after warm-up);
3. build the production forward: ``bench.py``'s ``PROD_CFG`` (4-agent
   mixed fleet, 4 x 512^2 cameras per camera agent, 512^2 pillar grid,
   128^2 x 256 BEV, 2 H3GAT iterations) and its request batch, with the
   serving hints, weights drawn from a seeded ``torch.Generator``;
4. run it in float32 with the kernels and with ``plain_ops()``, and
   compare sigmoid(psm) and rm;
5. answer 3 bfloat16 requests (batch seeds 0-2) through forward, anchor
   decode and rotated NMS; every output must be finite and every kernel
   must have launched on that path; then time 20 more requests (the 3
   batches in turn) and print the median and spread of ms/frame.

The script imports torch, numpy, the port and the jax-free numpy modules
of the JAX package (synthetic batches, anchor grid) and ``bench.py``'s
configuration, never jax itself.

The lines before the last are the per-kernel JSON record and the card's
name and power limit; the last line is ``{"ok": true, "device": ...}``.
Any failure raises (non-zero exit, no result line).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# kernel vs plain twin on unit-normal inputs at the serving shapes.
# float32: the same arithmetic in another summation order.
FP32_ATOL = 1e-4
# bfloat16: both sides compute in float32 from the same bf16 inputs and
# round the output once; the warp's hat weights are rounded to bf16 at
# slightly different points (fp32 hat vs bf16 1 - frac), so a few
# output ulps (bf16 ulp = 1/64 at |x| in [2, 4)) may differ.
BF16_ATOL = {"pair_warp": 0.0625, "stripe_window_attention": 0.0313,
             "plain_window_attention": 0.0313}
# full float32 forward, kernels vs plain twins: kernel rounding noise
# (~1e-6 relative) carried through the decoder
FORWARD_ATOL = 2e-3

KERNEL_META = {
    "pair_warp": ("hmvit_tpu_torch/csrc/pair_warp.cu",
                  "hmvit_tpu/ops/fused_warp.py:215"),
    "stripe_window_attention": ("hmvit_tpu_torch/csrc/window_attention.cu",
                                "hmvit_tpu/ops/window_attention.py:342"),
    "plain_window_attention": ("hmvit_tpu_torch/csrc/window_attention.cu",
                               "hmvit_tpu/ops/window_attention.py:157"),
}


NUM_AGENTS = 4
TIMED_REQUESTS = 20


def prod_batch(seed: int):
    """bench.py's request: 4 agents in 5 slots, alternating lidar /
    camera, 30 000 points per lidar agent, 4 x 512^2 images per camera
    agent."""
    from bench import PROD_RANGE
    from hmvit_tpu.data.synthetic import make_hetero_batch

    batch, _ = make_hetero_batch(
        seed=seed, max_cav=5, num_agents=NUM_AGENTS, max_points=30000,
        image_size=512, num_cams=4, camera_ratio=0.5, ego_mode="mixed",
        lidar_range=PROD_RANGE)
    for i in range(NUM_AGENTS):
        batch["mode"][:, i] = (i + 1) % 2
    return batch


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_kernels(dev, pairwise, agent_mask):
    """Phase 2: each kernel vs its plain twin at the serving shapes."""
    import torch

    from hmvit_tpu_torch.models.hetero_fusion import (
        _window_split,
        pairwise_roi_mask,
    )
    from hmvit_tpu_torch.ops import plain_ops
    from hmvit_tpu_torch.ops.fused_warp import (
        fused_pair_warp,
        pair_warp_launch,
    )
    from hmvit_tpu_torch.ops.window_attention import (
        fused_plain_window_attention,
        fused_stripe_window_attention,
        plain_window_attention_launch,
        stripe_window_attention_launch,
    )
    from hmvit_tpu_torch.utils.precision import strict_fp32

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    l, hw, c, heads, d, win = 4, 128, 256, 8, 32, 8
    t = win * win
    mode = torch.tensor([[1, 0, 1, 0]], device=dev)
    pair_mask = pairwise_roi_mask(pairwise, agent_mask, (hw, hw), 0.4, 4)
    mask_ij = pair_mask[0].movedim(-1, 1).contiguous()  # (I, J, H, W)
    mask_ij[0, :, :16, :16] = 0  # a fully masked patch: rows emit zeros
    bias = randn(heads, t, t) * 0.5

    def warp(dt, ty, mode_, receivers):
        args = (randn(1, ty, l, hw, hw, 2 * c).to(dt), pairwise, mode_,
                0.4, 4, receivers)
        return args, fused_pair_warp, pair_warp_launch

    def stripe(dt):
        args = (randn(l, hw, hw, c).to(dt), randn(l, l, hw, hw, 2 * c).to(dt),
                bias.to(dt), mask_ij.to(dt), win, heads, d)
        return (args, fused_stripe_window_attention,
                stripe_window_attention_launch)

    def plain(dt, n, j, mask):
        args = (randn(n, 256, t, c).to(dt), randn(n, j, 256, t, 2 * c).to(dt),
                bias.to(dt), mask.to(dt), heads, d)
        return (args, fused_plain_window_attention,
                plain_window_attention_launch)

    grid_mask = _window_split(mask_ij[..., None], win, "grid")[..., 0] \
        .reshape(l, l, 256, t)
    cases = {
        "pair_warp": [
            ("local I=4 TY=2", lambda dt: warp(dt, 2, mode, None)),
            ("ego I=1 TY=1", lambda dt: warp(dt, 1, torch.zeros_like(mode),
                                             1)),
        ],
        "stripe_window_attention": [("local J=4", stripe)],
        "plain_window_attention": [
            ("grid J=4", lambda dt: plain(dt, l, l, grid_mask)),
            ("camera J=1", lambda dt: plain(
                dt, 2, 1, torch.ones(2, 1, 256, t, device=dev))),
        ],
    }
    record = {}
    for name, variants in cases.items():
        bf16_err = 0.0
        ms = plain_ms = None
        for label, make in variants:
            for dt, tol in ((torch.float32, FP32_ATOL),
                            (torch.bfloat16, BF16_ATOL[name])):
                args, fn, prep = make(dt)
                with strict_fp32():
                    got = fn(*args)
                    with plain_ops():
                        want = fn(*args)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError(f"{name} {label}: {got.shape} "
                                         f"{got.dtype} vs {want.shape}")
                err = float((got.float() - want.float()).abs().max())
                key = str(dt).split(".")[-1]
                print(f"  {name} [{label}, {key}]: max_abs_err {err:.3e} "
                      f"(tol {tol})")
                if not np.isfinite(err) or err > tol:
                    raise AssertionError(
                        f"{name} {label} {key}: kernel vs plain twin "
                        f"max_abs_err {err} > {tol}")
                if dt == torch.bfloat16:
                    bf16_err = max(bf16_err, err)
                    # the kernel alone (inputs laid out once), the whole
                    # wrapper (geometry prep, layout, launch) and the twin
                    launch, _ = prep(*args)
                    k_ms = time_ms(launch)
                    w_ms = time_ms(lambda: fn(*args))
                    with plain_ops():
                        p_ms = time_ms(lambda: fn(*args))
                    print(f"  {name} [{label}, bfloat16]: kernel {k_ms:.4f} "
                          f"ms, wrapper {w_ms:.4f} ms, plain twin "
                          f"{p_ms:.4f} ms")
                    if ms is None:  # the first variant is the record's
                        ms, plain_ms = k_ms, p_ms
                del args, got, want
        record[name] = {"max_abs_err": bf16_err, "ms": ms,
                        "plain_ms": plain_ms}
    return record


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    from bench import PROD_CFG, PROD_RANGE
    from hmvit_tpu.data.anchors import generate_anchor_grid
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops import cuda, plain_ops
    from hmvit_tpu_torch.postprocess import decode_detections_device
    from hmvit_tpu_torch.serving import (
        batch_to_device,
        serving_config,
        serving_hints,
    )
    from hmvit_tpu_torch.utils.precision import strict_fp32

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    cuda.load_library(verbose=True)
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s")

    # -- 2. kernels vs plain twins ----------------------------------------
    batch0 = prod_batch(0)
    geo = batch_to_device(batch0, dev, bf16=False)
    record = check_kernels(dev, geo["pairwise_t_matrix"][:, :4, :4],
                           geo["agent_mask"][:, :4])
    torch.cuda.empty_cache()

    # -- 3. the production model -------------------------------------------
    hints = serving_hints(batch0["mode"][0], NUM_AGENTS)
    model32 = init_parameters(HMViT(serving_config(PROD_CFG, bf16=False)),
                              seed=0).to(dev).eval()
    # the anchors of the 512^2 pillar grid at feature stride 4 (128^2)
    anchor_args = {"W": 512, "H": 512, "l": 3.9, "w": 1.6, "h": 1.56,
                   "r": [0, 90], "num": 2, "feature_stride": 4,
                   "vw": 0.4, "vh": 0.4, "cav_lidar_range": PROD_RANGE}
    anchors = torch.as_tensor(generate_anchor_grid(anchor_args, "hwl"),
                              dtype=torch.float32, device=dev)
    eye = torch.eye(4, device=dev)

    # -- 4. float32 forward: kernels vs plain twins -------------------------
    cuda.reset_launches()
    with torch.no_grad(), strict_fp32():
        out_k = model32(geo, **hints)
        fp32_counts = cuda.launch_counts()
        print(f"fp32 forward with kernels: launches {fp32_counts}")
        if min(fp32_counts.values()) <= 0:
            raise AssertionError("fp32 forward skipped a kernel")
        with plain_ops():
            out_p = model32(geo, **hints)
    torch.cuda.synchronize()
    for key, fn in (("psm", torch.sigmoid), ("rm", lambda z: z)):
        a, b = fn(out_k[key].float()), fn(out_p[key].float())
        scale = max(1.0, float(b.abs().max()))
        err = float((a - b).abs().max()) / scale
        print(f"forward fp32 {key} {tuple(a.shape)}: kernels vs plain "
              f"max_abs_err/scale {err:.3e} (tol {FORWARD_ATOL})")
        if not (torch.isfinite(a).all() and err <= FORWARD_ATOL):
            raise AssertionError(f"fp32 forward {key} disagrees: {err}")
    # decode + NMS over every anchor (threshold 0: random weights put all
    # scores near the focal prior 0.01, under the serving threshold)
    kept = []
    for out in (out_k, out_p):
        corners, _, valid = decode_detections_device(
            out["psm"], out["rm"], anchors, eye, score_threshold=0.0)
        kept.append(corners[valid])
    print(f"fp32 decode+NMS at threshold 0: kept {len(kept[0])} (kernels) "
          f"vs {len(kept[1])} (plain) of 512 candidates")
    if kept[0].shape != kept[1].shape or \
            float((kept[0] - kept[1]).abs().max()) > 1e-3:
        raise AssertionError("fp32 decode+NMS: kernels and plain twins keep "
                             "different boxes")
    del model32, out_k, out_p
    torch.cuda.empty_cache()

    # -- 5. three bfloat16 requests through forward, decode, NMS ------------
    model16 = init_parameters(HMViT(serving_config(PROD_CFG, bf16=True)),
                              seed=0).to(dev, torch.bfloat16).eval()
    requests = [batch_to_device(prod_batch(s), dev, bf16=True)
                for s in range(3)]

    def serve(b):
        """One request; returns the outputs and the host-clock ms of the
        forward and of decode + NMS (the card synchronised after each)."""
        t0 = time.perf_counter()
        with torch.no_grad():
            out = model16(b, **hints)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            det = decode_detections_device(out["psm"], out["rm"], anchors,
                                           eye)
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        return out, det, ((t1 - t0) * 1e3, (t2 - t1) * 1e3)

    serve(requests[0])  # warm-up (cuDNN autotune, allocator)
    cuda.reset_launches()
    for i, b in enumerate(requests):
        out, (corners, scores, valid), stages = serve(b)
        for key, shape in (("psm", (1, 2, 128, 128)),
                           ("rm", (1, 14, 128, 128))):
            if tuple(out[key].shape) != shape or \
                    not torch.isfinite(out[key].float()).all():
                raise AssertionError(f"request {i}: bad {key} "
                                     f"{tuple(out[key].shape)}")
        if not torch.isfinite(corners).all():
            raise AssertionError(f"request {i}: non-finite boxes")
        print(f"request {i}: {sum(stages):.2f} ms (forward {stages[0]:.2f}"
              f", decode + NMS {stages[1]:.2f}), {int(valid.sum())} boxes "
              f"kept")
    counts = cuda.launch_counts()
    print(f"launches during the 3 requests: {counts}")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}")
    stage_ms = np.asarray([serve(requests[i % len(requests)])[2]
                           for i in range(TIMED_REQUESTS)])
    frame_ms = stage_ms.sum(axis=1)
    fwd_ms, dec_ms = np.median(stage_ms, axis=0)
    print(f"bf16 serving, {TIMED_REQUESTS} requests: median "
          f"{float(np.median(frame_ms)):.2f} ms/frame (min "
          f"{float(frame_ms.min()):.2f}, max {float(frame_ms.max()):.2f}; "
          f"forward + decode + NMS, batch 1; medians forward "
          f"{fwd_ms:.2f} ms, decode + NMS {dec_ms:.2f} ms) on {card}")

    kernels = [{"name": name, "route": "cuda",
                "source": KERNEL_META[name][0],
                "replaces": KERNEL_META[name][1],
                "launches": counts[name],
                "max_abs_err": rec["max_abs_err"],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"]}
               for name, rec in record.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
