"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell's entries in ``BENCHMARK.json``
name its configuration (``benchmark/configs/``), its traffic mix
(``benchmark/traffic/``, whose ``runner`` is a module of this package:
``serve`` or ``train``) and its limits (``benchmark/limits/<cell>.json``).
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer ones with ``--trace 1``), ``device``,
with ``--trace 1`` ``breakdown``, and last ``compared``: each number the
comparison with the reference reads, beside its limit.  Exits 2 without
enough CUDA cards, 3 if JAX or the JAX package was loaded, and prints no
result then.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hmvit_tpu")
# the program's build and kernel caches, at fixed paths in the checkout
CACHES = {"TRITON_CACHE_DIR": ".bench_cache/triton",
          "TORCH_EXTENSIONS_DIR": ".bench_cache/torch_extensions"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def reader(name: str):
    """(read function, part) of a per-layer metric: ``<kernel>_roofline``
    is read by ``metrics/roofline.py`` for that kernel, ``<prefix>.<part>``
    by ``metrics/<prefix>.py`` for that part (see
    ``benchmark/metrics/__init__.py``)."""
    if name.endswith("_roofline"):
        module, part = "roofline", name[:-len("_roofline")]
    else:
        module, _, part = name.partition(".")
    mod = importlib.import_module(f"benchmark.metrics.{module}")
    return mod.read, part or None


def judge(compared: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    if sorted(compared) != sorted(limits):
        raise KeyError(f"compared {sorted(compared)} but limits "
                       f"{sorted(limits)}")
    table = {k: {"value": compared[k], "limit": limits[k]}
             for k in sorted(compared)}
    return all(v["value"] <= v["limit"] for v in table.values()), table


def result_line(spec: dict, out: dict, trace: bool, device) -> dict:
    """The result object (see the module's docstring)."""
    import torch

    correct, table = judge(out["compared"], spec["limits"])
    units = {m["name"]: m["unit"] for m in spec["end_to_end"]
             + spec["per_layer"]}
    if trace:
        ctx = out["ctx"]
        values = {}
        for m in spec["per_layer"]:
            read, part = reader(m["name"])
            v = read(ctx, part)
            if v is not None:
                values[m["name"]] = v
    else:
        values = dict(out["end_to_end"], setup_s=out["setup_s"])
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": spec["chips"],
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": float(v), "unit": units[k]}
                        for k, v in values.items()},
            "device": dev}
    if trace:
        dev.update(busy_s=out["ctx"]["busy_s"],
                   window_s=out["ctx"]["window_s"])
        line["breakdown"] = out["ctx"]["breakdown"]
    line["compared"] = table
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)

    from . import manifest

    spec = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"benchmark: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runner = importlib.import_module(
        f"benchmark.{spec['traffic']['runner']}")
    out = runner.run(spec, args.seed, args.seconds, bool(args.trace),
                     T_START, device)
    line = result_line(spec, out, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: "
              f"{bad}", file=sys.stderr)
        return 3
    for text in out.get("stderr", []):
        print(text, file=sys.stderr)
    if args.trace:
        for cls, s in out["ctx"].get("classes", {}).items():
            print(f"device by class: {cls} {s:.6f} s", file=sys.stderr)
    for name, row in line["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
