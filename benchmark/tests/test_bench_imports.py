"""What the benchmark loads: never JAX or the JAX package (top-level names
compared whole, so ``hmvit_tpu_torch`` passes), and the reference nothing
of the program either."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "hmvit_tpu")


def loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    return set(out.stdout.split())


def bench_modules() -> list[str]:
    mods = []
    for path in sorted((ROOT / "benchmark").rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        if "tests" in rel.parts:
            continue
        mods.append(".".join(p for p in rel.parts if p != "__init__"))
    return mods


def test_the_benchmark_loads_no_jax():
    code = "\n".join(f"import {m}" for m in bench_modules()) + "\n" + "\n".join(
        ["import hmvit_tpu_torch.graph_server, hmvit_tpu_torch.serving",
         "import hmvit_tpu_torch.train.trainer, hmvit_tpu_torch.models.hmvit",
         "from benchmark import run",
         "assert run.forbidden_modules() == []"])
    top = loaded_after(code)
    assert "hmvit_tpu_torch" in top and "benchmark" in top
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    refs = [m for m in bench_modules() if m.startswith("benchmark.reference")]
    assert len(refs) > 20
    top = loaded_after("\n".join(f"import {m}" for m in refs))
    assert not top & {*FORBIDDEN, "hmvit_tpu_torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "hmvit_tpu_torchx", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]
