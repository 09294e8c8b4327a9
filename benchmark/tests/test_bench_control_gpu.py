"""The control on the card at each cell's own size: the reference in
float8 (``compare.fp8_control``: e4m3 forward, e5m2 gradients) in the
program's place, three seeds a cell, must come out not correct; the
readings it prints are the upper readings the limits are set below.

    python -m pytest benchmark/tests/test_bench_control_gpu.py -m gpu -s

(on the card's machine; here it skips)."""
import pytest
import torch

from benchmark import compare, generator, manifest, run, train

SEEDS = (101, 202, 303)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cells' "
                    "own sizes")
    return torch.device("cuda", 0)


def cells(runner):
    return [w["name"] for w in manifest.load_manifest()["workloads"]
            if manifest.cell(w["name"])["traffic"]["runner"] == runner]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", cells("serve"))
def test_serve_control_is_not_correct(device, cell, seed):
    spec = manifest.cell(cell)
    pool = generator.make_pool(seed, spec["traffic"])
    samples = [(i, None, None, None, None, None) for i in range(len(pool))]
    numbers = compare.serve_numbers(samples, pool, spec["config"],
                                    spec["traffic"], seed, device,
                                    control=True)
    correct, table = run.judge(numbers, spec["limits"])
    print(f"control {cell} seed {seed}: {table}")
    assert not correct


@pytest.mark.gpu
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", cells("train"))
def test_train_control_is_not_correct(device, cell, seed):
    spec = manifest.cell(cell)
    config, traffic = spec["config"], spec["traffic"]
    pool = generator.make_pool(seed, traffic)
    labs = train.labels(pool, config, device)
    numbers, _ = compare.train_numbers(None, pool, labs, config, seed,
                                       device, traffic["checked_steps"],
                                       control=True)
    correct, table = run.judge(numbers, spec["limits"])
    print(f"control {cell} seed {seed}: {table}")
    assert not correct
