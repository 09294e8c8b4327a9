"""Port parity: the one-pass segmented max-scan.  The three cases of
tests/test_segscan.py go through the JAX package's Pallas kernel in
interpret mode and through the port's function (its plain version here,
on CPU tensors): equal on every last-of-run row whose id is >= 0 — rtol
1e-6 as the JAX test states it, and in fact bit for bit, since a maximum
rounds nothing.  Rows of the -1 (dropped) id are unspecified on both
sides and are not compared.  The gradient of the port's wrapper is held
to ``jax.grad`` through the log-shift scan on the consumed rows, 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops.segscan import fused_segmented_max_scan as jscan
from hmvit_tpu.ops.voxelize import segmented_scan as jsegmented_scan
from hmvit_tpu_torch.ops import cuda
from hmvit_tpu_torch.ops.segscan import (
    fused_segmented_max_scan,
    segmented_max_scan_launch,
    segmented_max_scan_plain,
)
from torch_parity import t


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _random_runs():
    """Runs of 1..32 rows, a fifth of them the dropped id -1."""
    rng = np.random.default_rng(0)
    p, c = 1024, 8
    seg, cur = [], 0
    while len(seg) < p:
        run = int(rng.integers(1, 33))
        seg.extend([-1 if rng.random() < 0.2 else cur] * run)
        cur += int(rng.integers(1, 3))
    return (np.asarray(seg[:p], np.int32),
            rng.normal(size=(p, c)).astype(np.float32), 128)


def _straddling_run():
    """A 32-row run across the first block boundary at row 64."""
    p, c = 256, 4
    seg = np.zeros(p, np.int32)
    seg[48:80] = 1
    seg[80:] = np.repeat(np.arange(2, 2 + (p - 80) // 8), 8)[:p - 80]
    vals = np.random.default_rng(1).normal(size=(p, c)).astype(np.float32)
    return seg, vals, 64


def _giant_dropped_run():
    """Only the -1 id may exceed 2**steps rows; its neighbours stay
    exact."""
    p, c = 512, 4
    seg = np.full(p, -1, np.int32)
    seg[:16], seg[-8:] = 3, 7
    vals = np.random.default_rng(2).normal(size=(p, c)).astype(np.float32)
    return seg, vals, 128


CASES = {"random_runs": _random_runs, "straddling_run": _straddling_run,
         "giant_dropped_run": _giant_dropped_run}


def _consumed(seg):
    nxt = np.concatenate([seg[1:], [np.iinfo(np.int32).min]])
    return (seg != nxt) & (seg >= 0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_pallas_kernel_on_consumed_rows(case):
    seg, vals, block = CASES[case]()
    want = np.asarray(jscan(jnp.asarray(vals), jnp.asarray(seg), steps=5,
                            block_rows=block, interpret=True))
    got = fused_segmented_max_scan(t(vals), t(seg), 5).numpy()
    rows = _consumed(seg)
    assert rows.any()
    np.testing.assert_allclose(got[rows], want[rows], rtol=1e-6)
    assert np.array_equal(got[rows], want[rows])
    # each consumed row holds its run's maximum (runs within the
    # contract: at most 2**steps rows)
    for r in np.flatnonzero(rows)[::7]:
        start = r
        while start > 0 and seg[start - 1] == seg[r]:
            start -= 1
        if r + 1 - start <= 32:
            assert np.array_equal(got[r], vals[start:r + 1].max(axis=0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_version_is_the_log_shift_scan(dtype):
    """Every row with id >= 0 against the JAX log-shift scan, bit for
    bit, float32 and bfloat16."""
    seg, vals, _ = _random_runs()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jv = jnp.asarray(vals).astype(jdt)
    want = np.asarray(jsegmented_scan(
        jv, jnp.asarray(seg), 5, jnp.maximum,
        jnp.asarray(-jnp.inf, jdt)).astype(jnp.float32))
    got = segmented_max_scan_plain(t(vals).to(dtype), t(seg), 5)
    assert got.dtype == dtype
    rows = seg >= 0
    assert np.array_equal(got.float().numpy()[rows], want[rows])


def test_gradient_matches_jax_on_consumed_rows():
    seg, vals, _ = _random_runs()
    rows = _consumed(seg)
    weight = np.random.default_rng(3).normal(size=vals.shape).astype(
        np.float32) * rows[:, None]

    def loss(v):
        out = jsegmented_scan(v, jnp.asarray(seg), 5, jnp.maximum,
                              jnp.asarray(-jnp.inf, jnp.float32))
        return jnp.sum(out * jnp.asarray(weight))

    want = np.asarray(jax.grad(loss)(jnp.asarray(vals)))
    v = t(vals).requires_grad_()
    (fused_segmented_max_scan(v, t(seg), 5) * t(weight)).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), want, atol=1e-6)
    assert np.count_nonzero(want) == rows.sum() * vals.shape[1]


@pytest.mark.parametrize("c", [8, 12])
def test_launcher_takes_any_c_and_any_p(c):
    """Neither half of the JAX gate is kept: C = 12 is no multiple of 8
    and P = 1021 is prime.  Laying a launch out needs no card; launching
    on CPU tensors raises and counts nothing."""
    seg = torch.zeros(1021, dtype=torch.int32)
    with pytest.raises(TypeError):
        segmented_max_scan_launch(torch.zeros(1021, c, dtype=torch.float64),
                                  seg, 5)
    with pytest.raises(ValueError, match="steps"):
        segmented_max_scan_launch(torch.zeros(1021, c), seg, 31)
    launch, out = segmented_max_scan_launch(torch.zeros(1021, c), seg, 5)
    assert out.shape == (1021, c)
    before = cuda.SEGMENTED_MAX_SCAN.launches
    with pytest.raises(ValueError):
        launch()
    assert cuda.SEGMENTED_MAX_SCAN.launches == before
