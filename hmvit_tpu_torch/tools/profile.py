"""Trace analysis: device time by kernel class (the port of
``hmvit_tpu/tools/profile.py``, which reads an xplane trace).

Reads the chrome-trace JSON that ``torch.profiler`` exports
(``export_chrome_trace``; ``python -m hmvit_tpu_torch.tools.performance
--trace_dir`` writes one of a forward) and rolls its device events
(kernels, memcpys, memsets) up into classes:

    python -m hmvit_tpu_torch.tools.performance --model_dir runs/<run> \\
        --trace_dir /tmp/trace
    python -m hmvit_tpu_torch.tools.profile /tmp/trace [--frames 1] [--top 30]

``--frames`` divides the totals by the number of traced frames, so the
numbers read as ms/frame (of a traced train step: ``--frames 1``).  It
prints the total device time, the time of each class, and the ``--top``
device operations with their counts per frame.  The classes:
``convolution``, ``GEMM``, ``elementwise``, ``copy / permute``,
``reduction`` (reductions, norms, softmax, sort, scan, top-k), each
hand-written kernel of ``csrc/`` by the name of its wrapper
(``hand-written: pair_warp`` ...), ``memcpy / memset``, and
``other``.  A device event's time is its own duration, so kernels that
overlap are counted each in full.

``--ranges PREFIX`` also rolls up, by class, the device operations
launched inside each profiler range whose name starts with PREFIX (a
``torch.profiler.record_function``): ``--ranges twin_backward:`` gives
the device time of the kernels' plain-twin backward
(:func:`hmvit_tpu_torch.tracing.twin_backward`) by kernel and class.  A
device operation belongs to a range when the host call that launched it
(the runtime event of the same correlation id) lies inside the range on
the same thread.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import glob
import gzip
import json
import os
import re

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

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
    """The wrapper name (:data:`hmvit_tpu_torch.ops.cuda.KERNELS`) of a
    kernel of ``csrc/`` from its device function name, else None.  The
    tensor-core attention template is told apart by its template
    arguments ``<D, KC, G, TYPED, MODE>`` (MODE 0 split windows, 1
    stripe, 2 warped rows)."""
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
            (r"expand_slice_kernel<\s*false", "expand_rows"),
            (r"ms_deform_attn_kernel", "ms_deform_attn")):
        if re.search(pattern, name):
            return kernel
    return None


def op_class(name: str, category: str = "kernel") -> str:
    """The class of one device event (see the module's docstring)."""
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


def load_trace(path: str) -> dict:
    """The chrome trace at ``path``, or the first ``*.json`` /
    ``*.json.gz`` under it (recursive) if it is a directory."""
    if os.path.isdir(path):
        found = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                 recursive=True)
                       + glob.glob(os.path.join(path, "**", "*.json.gz"),
                                   recursive=True))
        if not found:
            raise SystemExit(f"no chrome trace (*.json) under {path}")
        path = found[0]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def device_op_totals(trace: dict):
    """({name: total us}, {name: count}, {name: category}) over the
    trace's device events."""
    agg, cnt, cat = collections.Counter(), collections.Counter(), {}
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = ev.get("name", "?")
        agg[name] += float(ev.get("dur", 0.0))
        cnt[name] += 1
        cat[name] = ev["cat"]
    return agg, cnt, cat


LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")


def range_totals(trace: dict, prefix: str) -> dict:
    """{range name: {class: device us}} over the device operations
    launched inside the profiler ranges named ``prefix...`` (see the
    module's docstring)."""
    events = [ev for ev in trace.get("traceEvents", [])
              if ev.get("ph") == "X"]
    launches = collections.defaultdict(list)  # (pid, tid) -> [(ts, corr)]
    for ev in events:
        if ev.get("cat") in LAUNCH_CATEGORIES:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[(ev.get("pid"), ev.get("tid"))].append(
                    (float(ev["ts"]), corr))
    for rows in launches.values():
        rows.sort()
    owner = {}
    for ev in events:
        if ev.get("cat") != "user_annotation" or \
                not ev.get("name", "").startswith(prefix):
            continue
        rows = launches.get((ev.get("pid"), ev.get("tid")), [])
        lo, hi = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))
        for i in range(bisect.bisect_left(rows, (lo,)), len(rows)):
            if rows[i][0] > hi:
                break
            owner[rows[i][1]] = ev["name"]
    out = collections.defaultdict(collections.Counter)
    for ev in events:
        if ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = owner.get(ev.get("args", {}).get("correlation"))
        if name is not None:
            out[name][op_class(ev.get("name", "?"), ev["cat"])] += \
                float(ev.get("dur", 0.0))
    return {name: dict(classes) for name, classes in out.items()}


def summarize(path: str, top: int = 30, frames: int = 1,
              ranges: str | None = None) -> dict:
    trace = load_trace(path)
    agg, cnt, cat = device_op_totals(trace)
    scale = 1e3 * frames  # us -> ms, per frame
    total = sum(agg.values())
    print(f"total device time: {total / scale:.3f} ms/frame "
          f"({frames} frame(s), {sum(cnt.values()) / frames:.0f} device "
          "operations a frame)")
    groups, group_cnt = collections.Counter(), collections.Counter()
    for name, us in agg.items():
        cls = op_class(name, cat[name])
        groups[cls] += us
        group_cnt[cls] += cnt[name]
    print("-- by class (ms/frame, operations a frame):")
    for cls, us in groups.most_common():
        print(f"  {us / scale:8.3f}  x{group_cnt[cls] / frames:6.0f}  {cls}")
    print(f"-- top {top} device operations (ms/frame):")
    for name, us in agg.most_common(top):
        print(f"  {us / scale:7.3f} x{cnt[name] // max(frames, 1):4d}"
              f"  {name[:100]}")
    result = {"total_ms": total / scale,
              "by_class": {k: us / scale for k, us in groups.items()},
              "top": [(name, us / scale, cnt[name] // max(frames, 1))
                      for name, us in agg.most_common(top)]}
    if ranges:
        inside = range_totals(trace, ranges)
        result["ranges"] = {name: {cls: us / scale for cls, us in
                                   classes.items()}
                            for name, classes in inside.items()}
        whole = sum(sum(c.values()) for c in inside.values())
        print(f"-- inside ranges {ranges}* (ms/frame): {whole / scale:.3f}")
        for name, classes in sorted(inside.items()):
            print(f"  {sum(classes.values()) / scale:8.3f}  {name}: "
                  + ", ".join(f"{cls} {us / scale:.3f}" for cls, us in
                              sorted(classes.items(), key=lambda kv: -kv[1])))
    return result


def main(argv=None):
    p = argparse.ArgumentParser("hmvit_tpu_torch chrome-trace analyzer")
    p.add_argument("trace", help="a chrome-trace .json, or a directory")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--frames", type=int, default=1,
                   help="traced frame count (totals divided by this)")
    p.add_argument("--ranges", default=None,
                   help="also roll up the device time inside the profiler "
                        "ranges of this name prefix, e.g. twin_backward:")
    a = p.parse_args(argv)
    summarize(a.trace, top=a.top, frames=a.frames, ranges=a.ranges)


if __name__ == "__main__":
    main()
