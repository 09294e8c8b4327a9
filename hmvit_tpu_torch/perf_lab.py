"""Stage-level timing of the fusion-stage kernels on the card
(counterpart of the fusion stages of the JAX package's ``perf_lab.py``).

    python -m hmvit_tpu_torch.perf_lab [stage ...] [--iters N] [--cpu]

Stages (default: all), at the production shapes B = 1, 128^2 x 256 maps,
8 heads of 32, window 8, two type variants:

* ``attn`` — the typed window-attention kernel, L = 5, float32;
* ``pairwarp`` — the pair-warp tile kernel, L = 4 and 5, bfloat16;
* ``pairwarp_res`` — the resident pair-warp kernel beside the tile
  kernel, (L, receivers) = (4, all), (5, all), (4, 1); the outputs must
  be equal bit for bit;
* ``fused_wa`` — the fused warp + attention kernel beside the pair warp
  followed by the stripe attention kernel, L = 4, L = 4 with one
  receiver, L = 5; equal bit for bit.

Times are CUDA-event medians of ``--iters`` calls of the wrapper (inputs
on the card, pose geometry included), each line with the card's name and
power limit.  Without a CUDA device the module fails; ``--cpu`` is a
rehearsal of the control flow on the kernels' plain twins at a tiny
size, whose times say nothing about the card.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from .ops.fused_warp import fused_pair_warp
from .ops.fused_warp_attention import fused_warp_window_attention
from .ops.window_attention import (
    fused_stripe_window_attention,
    fused_window_attention,
)


@dataclasses.dataclass(frozen=True)
class Shapes:
    hw: int = 128
    heads: int = 8
    dim_head: int = 32
    win: int = 8

    @property
    def c(self) -> int:
        return self.heads * self.dim_head


PROD = Shapes()
TINY = Shapes(hw=64, heads=2, dim_head=8)


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

    def rand_pairwise(self, l: int):
        """Random rigid pairwise transforms (1, L, L, 4, 4);
        pairwise[b, j, i] = inv(M_i) @ M_j maps j's frame into i's."""
        ang = (self.rand(1, l) * 2 - 1) * np.pi
        pos = (self.rand(1, l, 2) * 2 - 1) * 20.0
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


STAGES = {
    "attn": lambda lab: stage_attn_typed(lab, torch.float32),
    "pairwarp": lambda lab: [stage_pairwarp(lab, torch.bfloat16, l)
                             for l in (4, 5)],
    "pairwarp_res": lambda lab: [stage_pairwarp_res(lab, l, r)
                                 for l, r in ((4, None), (5, None), (4, 1))],
    "fused_wa": lambda lab: [stage_fused_wa(lab, torch.bfloat16, l, r)
                             for l, r in ((4, None), (4, 1), (5, None))],
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
