"""Reduction of a ``torch.profiler`` chrome trace to what the per-layer
metrics read: device intervals, busy time, idle gaps labelled by the host
operation running through them, device time inside profiler ranges, and
device time by operation class.

The class rules and the range attribution (a device operation belongs to
a range when the host call that launched it, the runtime event of the
same correlation id, lies inside the range on the same thread) are
frozen copies of ``hmvit_tpu_torch/tools/profile.py``'s.
"""
from __future__ import annotations

import bisect
import collections
import json
import os
import re
import tempfile

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function",
                   "cuda_runtime", "cuda_driver")

# (class, pattern on the lower-cased kernel name), first match wins
CLASS_RULES = (
    ("convolution", re.compile(r"conv|cudnn|fprop|dgrad|wgrad|implicit_gemm"
                               r"|winograd")),
    ("GEMM", re.compile(r"gemm|gemv|cublas|cutlass|xmma|matmul|_mma_|"
                        r"sm\d+_.*tensorop")),
    ("copy / permute", re.compile(r"copy|permute|transpose|catarray|index|"
                                  r"gather|scatter|nchwtonhwc|nhwctonchw|"
                                  r"flip|roll|pad|tril|triu")),
    ("reduction", re.compile(r"reduce|norm|softmax|sort|scan|topk|argmax|"
                             r"argmin|cub::|sum_kernel")),
    ("elementwise", re.compile(r"elementwise|pointwise|functor|fill|"
                               r"distribution|where|clamp")),
)


def hand_written_kernel(name: str) -> str | None:
    """The port's wrapper name of a kernel of its ``csrc/`` from the device
    function's name, else None (the tensor-core attention template is
    told apart by its template arguments ``<D, KC, G, TYPED, MODE>``)."""
    mma = re.search(r"window_attention_mma_kernel<([^>]*)>", name)
    if mma:
        args = [a.strip() for a in mma.group(1).split(",")]
        if args[3] == "true":
            return "typed_window_attention"
        return {"0": "plain_window_attention", "1": "stripe_window_attention",
                "2": "warp_window_attention"}.get(args[4].rstrip("u"))
    for pattern, kernel in (
            (r"pair_warp_resident_kernel", "pair_warp_resident"),
            (r"pair_warp_previous_kernel", "pair_warp_previous"),
            (r"pair_warp_kernel", "pair_warp"),
            (r"warp_window_attention_kernel", "warp_window_attention"),
            (r"typed_window_attention_kernel", "typed_window_attention"),
            (r"window_attention_kernel<[^,>]*,\s*true",
             "stripe_window_attention"),
            (r"window_attention_kernel<[^,>]*,\s*false",
             "plain_window_attention"),
            (r"segmented_max_scan_previous_kernel",
             "segmented_max_scan_previous"),
            (r"segmented_max_scan_(carry_)?kernel", "segmented_max_scan"),
            (r"expand_slice_kernel<\s*true", "expand_rows_v2"),
            (r"expand_slice_kernel<\s*false", "expand_rows")):
        if re.search(pattern, name):
            return kernel
    return None


def op_class(name: str, category: str = "kernel") -> str:
    if category in ("gpu_memcpy", "gpu_memset"):
        return "memcpy / memset"
    kernel = hand_written_kernel(name)
    if kernel:
        return "hand-written: " + kernel
    low = name.lower()
    for cls, pattern in CLASS_RULES:
        if pattern.search(low):
            return cls
    return "other"


def export(prof) -> dict:
    """The profiler's chrome trace as a dict (written to a temporary file
    under ``TMPDIR`` and removed)."""
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)


class Trace:
    """The events of one exported trace, sorted by start (microseconds)."""

    def __init__(self, trace: dict):
        events = [ev for ev in trace.get("traceEvents", [])
                  if ev.get("ph") == "X" and "ts" in ev]
        for ev in events:
            ev["ts"] = float(ev["ts"])
            ev["dur"] = float(ev.get("dur", 0.0))
        events.sort(key=lambda ev: ev["ts"])
        self.events = events
        self.device = [ev for ev in events
                       if ev.get("cat") in DEVICE_CATEGORIES]
        self.host = [ev for ev in events if ev.get("cat") in HOST_CATEGORIES]

    def annotations(self, name: str) -> list[dict]:
        return [ev for ev in self.events if ev.get("cat") == "user_annotation"
                and ev.get("name") == name]

    def device_in(self, lo: float, hi: float) -> list[dict]:
        return [ev for ev in self.device if lo <= ev["ts"] < hi]

    def launched_inside(self, prefix: str) -> dict:
        """{range name: [device events launched inside it]} over the
        ranges named ``prefix...``."""
        launches = collections.defaultdict(list)
        for ev in self.events:
            if ev.get("cat") in LAUNCH_CATEGORIES:
                corr = ev.get("args", {}).get("correlation")
                if corr is not None:
                    launches[(ev.get("pid"), ev.get("tid"))].append(
                        (ev["ts"], corr))
        for rows in launches.values():
            rows.sort()
        owner = {}
        for ev in self.events:
            if ev.get("cat") != "user_annotation" or \
                    not ev.get("name", "").startswith(prefix):
                continue
            rows = launches.get((ev.get("pid"), ev.get("tid")), [])
            lo, hi = ev["ts"], ev["ts"] + ev["dur"]
            for i in range(bisect.bisect_left(rows, (lo,)), len(rows)):
                if rows[i][0] > hi:
                    break
                owner[rows[i][1]] = ev["name"]
        out = collections.defaultdict(list)
        for ev in self.device:
            name = owner.get(ev.get("args", {}).get("correlation"))
            if name is not None:
                out[name].append(ev)
        return dict(out)


def union(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as sorted disjoint ones."""
    merged = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def busy_us(events, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi) in which some device operation ran."""
    return sum(min(b, hi) - max(a, lo) for a, b in union(
        (ev["ts"], ev["ts"] + ev["dur"]) for ev in events)
        if min(b, hi) > max(a, lo))


def idle_gaps(trace: Trace, lo: float, hi: float, top: int = 10):
    """The ``top`` longest stretches of [lo, hi) with nothing on the
    device, each [label, seconds]: the label is the innermost host
    operation running at the gap's midpoint."""
    busy = union((ev["ts"], ev["ts"] + ev["dur"])
                 for ev in trace.device_in(lo, hi))
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inside = [ev for ev in trace.host
                  if ev["ts"] <= mid < ev["ts"] + ev["dur"]]
        label = max(inside, key=lambda ev: ev["ts"])["name"] if inside \
            else "host: no operation traced"
        out.append([label, (b - a) * 1e-6])
    return out


def top_ops(events, top: int = 10):
    """[[name, seconds]] of the device operations that took most time."""
    agg = collections.Counter()
    for ev in events:
        agg[ev.get("name", "?")] += ev["dur"]
    return [[name, us * 1e-6] for name, us in agg.most_common(top)]


def by_class(events) -> dict:
    agg = collections.Counter()
    for ev in events:
        agg[op_class(ev.get("name", "?"), ev.get("cat"))] += ev["dur"] * 1e-6
    return dict(agg.most_common())
