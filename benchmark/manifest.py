"""``BENCHMARK.json`` and the data files it names: a cell's configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``) and
limits (``limits/<cell>.json``), found by name."""
from __future__ import annotations

import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of a cell reads: the manifest's entries of the
    cell, its configuration, traffic and limits, and the metrics it
    reports (end to end, and per layer)."""
    manifest = load_manifest(root)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; cells: "
                       f"{sorted(cells)}")
    work = cells[name]
    config_entry = {c["name"]: c for c in manifest["configs"]}[work["config"]]
    bench = root / "benchmark"

    def applies(metric):
        return "workloads" not in metric or name in metric["workloads"]

    end_to_end = [m for m in manifest["end_to_end"] if applies(m)]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if m["moves"] in reported and applies(m)]
    return {"workload": work, "chips": work["chips"],
            "config": _json(root / config_entry["file"]),
            "traffic": _json(bench / "traffic" / f"{work['traffic']}.json"),
            "limits": _json(bench / "limits" / f"{name}.json"),
            "end_to_end": end_to_end, "per_layer": per_layer}
