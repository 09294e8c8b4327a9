"""``BENCHMARK.json`` against the contract's form, and the data-driven
layout: a new traffic mix is a new file and a new entry, nothing else."""
import json
import shutil
from pathlib import Path

from benchmark import generator, manifest

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def load():
    return manifest.load_manifest(ROOT)


def test_top_level_form():
    m = load()
    assert set(m) == KEYS
    assert m["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert m["paths"] == ["benchmark"]
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    assert len(json.dumps(m)) < 64 * 1024


def test_names_units_and_entry_keys():
    m = load()
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert manifest.NAME.match(c["name"])
        assert all(manifest.NAME.match(k) for k in c["reduced"])
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        for key in ("name", "config", "traffic"):
            assert manifest.NAME.match(w[key])
        names.append(w["name"])
    for metric in m["end_to_end"] + m["per_layer"]:
        assert manifest.NAME.match(metric["name"])
        assert manifest.UNIT.match(metric["unit"])
        assert metric["better"] in ("lower", "higher")
        names.append(metric["name"])
    assert len(names) == len(set(names))
    for metric in m["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    assert "setup_s" in {x["name"] for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert "\n" not in metric["layer"] and len(metric["layer"]) <= 200


def test_every_cell_reports_what_its_metrics_move():
    m = load()
    cells = {w["name"] for w in m["workloads"]}
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for metric in m["per_layer"]:
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= cells
        assert set(metric["workloads"]) <= set(
            moved.get("workloads", cells))
    for cell in cells:
        spec = manifest.cell(cell, ROOT)
        reported = {x["name"] for x in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"], cell
        assert spec["traffic"]["runner"] in ("serve", "train")
        assert spec["limits"], cell


def test_a_new_traffic_mix_is_only_data(tmp_path):
    """A throwaway traffic file and a cell entry in a copy of the tree:
    the harness finds both by name and the generator draws from it."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = load()
    t = json.loads((ROOT / "benchmark/traffic/mixed_serve.json").read_text())
    t.update(modes=[0, 1, 0, 1], image_size=16, pool=2)
    (tmp_path / "benchmark/traffic/throwaway_serve.json").write_text(
        json.dumps(t))
    m["workloads"].append({"name": "hmvit_planar.throwaway_serve",
                           "config": "hmvit_planar",
                           "traffic": "throwaway_serve", "chips": 1,
                           "why": "a test's cell"})
    for metric in m["end_to_end"] + m["per_layer"]:
        if "hmvit_planar.mixed_serve" in metric.get("workloads", []):
            metric["workloads"] = metric["workloads"] + [
                "hmvit_planar.throwaway_serve"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    limits = tmp_path / "benchmark/limits/hmvit_planar.mixed_serve.json"
    shutil.copy(limits, limits.with_name("hmvit_planar.throwaway_serve.json"))
    spec = manifest.cell("hmvit_planar.throwaway_serve", tmp_path)
    assert spec["traffic"]["modes"] == [0, 1, 0, 1]
    assert {x["name"] for x in spec["end_to_end"]} == {
        "frames_per_s", "frame_p95_ms", "setup_s"}
    req = generator.make_pool(5, spec["traffic"])[0]
    assert req["mode"][0].tolist()[:4] == [0, 1, 0, 1]
