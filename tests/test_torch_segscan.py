"""Port parity: the one-pass segmented max-scan.  The three cases of
tests/test_segscan.py go through the JAX package's Pallas kernel in
interpret mode and through the port's function (its plain version here,
on CPU tensors): equal on every last-of-run row whose id is >= 0 — rtol
1e-6 as the JAX test states it, and in fact bit for bit, since a maximum
rounds nothing.  Rows of the -1 (dropped) id are unspecified on both
sides and are not compared.  The gradient of the port's wrapper is held
to ``jax.grad`` through the log-shift scan on the consumed rows, 1e-6.

``kernel_emulation`` models the CUDA kernel's partition
(``csrc/segscan.cu``): tiles of R rows, a slice of 8 rows a thread with
its running maximum, the slices joined through their tails, the head
carry from the rows before the tile (one launch) or, for runs longer
than a tile, from the last rows of the earlier tiles (the second
launch, in either block order).  It is held bit for bit to the plain
version on every row whose id is >= 0, and to the Pallas kernel where
its ``P % block_rows == 0`` gate allows.  Change it with the kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops.segscan import fused_segmented_max_scan as jscan
from hmvit_tpu.ops.segscan import pick_block_rows
from hmvit_tpu.ops.voxelize import segmented_scan as jsegmented_scan
from hmvit_tpu_torch.ops import cuda
from hmvit_tpu_torch.ops.segscan import (
    SLICE,
    fused_segmented_max_scan,
    scan_plan,
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


def _max_nan(a, b):
    """The kernel's combine: b where it is larger or NaN, else a (a holds
    the later rows and is kept on a tie)."""
    return torch.where((b > a) | torch.isnan(b), b, a)


def _head_carry(src, ids, id0, last, step, count, slices):
    """head_carry: count the candidates last - k * step (k < count) that
    hold id0, a batch of ``slices`` at a time, then reduce a contiguous
    chunk of them per slice and the chunks in order."""
    held, base = 0, 0
    while base < count:
        n = sum(base + s < count and ids[last - (base + s) * step] == id0
                for s in range(slices))
        held += n
        if n < slices:
            break
        base += slices
    chunk = -(-held // slices)
    parts = []
    for s in range(slices):
        k0, k1 = s * chunk, min(held, s * chunk + chunk)
        if k0 < k1:
            acc = src[last - k0 * step]
            for k in range(k0 + 1, k1):
                acc = _max_nan(acc, src[last - k * step])
            parts.append(acc)
    head = parts[0]
    for part in parts[1:]:
        head = _max_nan(head, part)
    return head


def kernel_emulation(vals, ids, steps, rows, carry_order="forward"):
    """The CUDA kernel's partition and order of combines, on the CPU.
    ``carry_order`` is the order in which the second launch's blocks run
    ("forward": a tile reads the earlier tiles' last rows after their
    blocks raised them; "reverse": before)."""
    p = vals.shape[0]
    ids = [int(i) for i in ids]
    out = vals.clone()
    lookback = (1 << steps) - 1
    two_pass = lookback > rows
    slices = rows // SLICE
    tiles = -(-p // rows)
    for t in range(tiles):
        r0 = t * rows
        n = min(rows, p - r0)
        tid = ids[r0:r0 + n] + [-1] * (rows - n)
        v = [vals[r0 + i] if i < n else torch.zeros_like(vals[0])
             for i in range(rows)]
        count = 0 if two_pass else min(lookback, r0)
        id0 = ids[r0]
        carried = count > 0 and id0 >= 0 and ids[r0 - 1] == id0
        if carried:
            head = _head_carry(vals, ids, id0, r0 - 1, 1, count, slices)
        for s in range(slices):
            for r in range(s * SLICE + 1, s * SLICE + SLICE):
                if tid[r] >= 0 and tid[r] == tid[r - 1]:
                    v[r] = _max_nan(v[r], v[r - 1])
        tails = [v[s * SLICE + SLICE - 1] for s in range(slices)]
        for s in range(slices):
            first = s * SLICE
            if first >= n:
                break
            id_s, carry = tid[first], None
            if id_s >= 0 and s > 0 and tid[first - 1] == id_s:
                carry = tails[s - 1]
                q = s - 2
                while q >= 0 and tid[q * SLICE + SLICE - 1] == id_s:
                    carry = _max_nan(carry, tails[q])
                    q -= 1
            if carried and id_s == id0:
                carry = head if carry is None else _max_nan(carry, head)
            if carry is not None:
                for r in range(first, first + SLICE):
                    if tid[r] != id_s:
                        break
                    v[r] = _max_nan(v[r], carry)
        out[r0:r0 + n] = torch.stack(v[:n])
    if two_pass:
        order = range(1, tiles)
        for t in (order if carry_order == "forward" else reversed(order)):
            r0 = t * rows
            id0 = ids[r0]
            if id0 < 0 or ids[r0 - 1] != id0:
                continue
            head = _head_carry(out, ids, id0, r0 - 1, rows, t, slices)
            for r in range(r0, min(p, r0 + rows)):
                if ids[r] != id0:
                    break
                out[r] = _max_nan(out[r], head)
    return out


def _runs_of(rng, p, max_run, dropped=0.2, cur=0):
    seg = []
    while len(seg) < p:
        run = int(rng.integers(1, max_run + 1))
        seg.extend([-1 if rng.random() < dropped else cur] * run)
        cur += int(rng.integers(1, 3))
    return seg[:p]


def _tile_case(name, rows):
    """(ids, steps) of one case, laid against tiles of ``rows`` rows."""
    rng = np.random.default_rng(len(name) + rows)
    if name == "straddling_runs":  # runs of 1..32 across every tile edge
        return _runs_of(rng, 3 * rows + 40, 32), 5
    if name == "runs_of_2_pow_steps":  # 32-row runs, one from R - 16 on
        seg = [0] * 16 + list(np.repeat(np.arange(1, 1 + rows), 32))
        return seg[:3 * rows], 5
    if name == "run_over_4_tiles":  # one run from R / 2 to 3.5 R, steps 12
        # (the log-shift scan's shifts need P > 2**11 rows)
        seg = (_runs_of(rng, rows // 2, 7) + [10 ** 6] * (3 * rows)
               + [10 ** 6 + 1 + i for i in range(rows // 2 + 24)])
        return seg + _runs_of(rng, 2100 - len(seg), 300, cur=2 * 10 ** 6), 12
    if name == "long_dropped_run":  # -1 x 200 over an edge, then a run
        seg = _runs_of(rng, rows - 40, 32, dropped=0.0) + [-1] * 200
        return seg + [10 ** 6] * 31 + _runs_of(rng, rows + 19, 32,
                                                 cur=10 ** 6 + 1), 5
    if name == "steps_0":  # every row its own run
        return [i if rng.random() < 0.8 else -1 for i in range(2 * rows + 8)], 0
    if name == "partial_last_tile":  # the last tile holds 5 rows
        seg = _runs_of(rng, 2 * rows - 3, 16, dropped=0.1)
        return seg + [seg[-1] + 1] * 8, 4
    raise KeyError(name)


TILE_CASES = ["straddling_runs", "runs_of_2_pow_steps", "run_over_4_tiles",
              "long_dropped_run", "steps_0", "partial_last_tile"]


@pytest.mark.parametrize("rows", [128, 256])
@pytest.mark.parametrize("c", [64, 12])
@pytest.mark.parametrize("case", TILE_CASES)
def test_kernel_tiling_equals_log_shift_scan(case, c, rows):
    seg, steps = _tile_case(case, rows)
    seg = np.asarray(seg, np.int32)
    p = len(seg)
    # the contract: each id >= 0 one run of at most 2**steps rows
    starts = np.flatnonzero(np.diff(seg, prepend=-2))
    lengths = np.diff(np.append(starts, p))
    held = seg[starts] >= 0
    assert len(set(seg[starts][held])) == held.sum()
    assert lengths[held].max() <= 1 << steps
    vals = np.random.default_rng(p).normal(size=(p, c)).astype(np.float32)
    want = segmented_max_scan_plain(t(vals), t(seg), steps).numpy()
    valid = seg >= 0
    outs = [kernel_emulation(t(vals), seg, steps, rows, order).numpy()
            for order in ("forward", "reverse")]
    for got in outs:
        assert np.array_equal(got[valid], want[valid])
    block = pick_block_rows(p)
    if block:
        pallas = np.asarray(jscan(jnp.asarray(vals), jnp.asarray(seg),
                                  steps=steps, block_rows=block,
                                  interpret=True))
        assert np.array_equal(outs[0][valid], pallas[valid])
    # the case reaches what it names
    two_pass = (1 << steps) - 1 > rows
    assert two_pass == (case == "run_over_4_tiles")
    edges = np.arange(rows, p, rows)
    crossed = valid[edges] & (seg[edges] == seg[edges - 1])
    assert crossed.any() == (case not in ("steps_0", "long_dropped_run"))
    assert p % rows or case != "partial_last_tile"
    if case == "long_dropped_run":  # a tile starts inside the -1 run
        assert (seg[edges] == -1).any()
        assert lengths[~held].max() > 1 << steps


@pytest.mark.parametrize("c,rows", [(64, 256), (8, 2048), (12, 168),
                                    (24, 680), (3, 680), (1, 2048),
                                    (512, 64), (520, 64)])
def test_scan_plan_mirrors_the_kernel(c, rows):
    """Rows a tile: 256 threads of 8 rows over up to 32 vectors of the
    row (8 channels each when C % 8 == 0); runs longer than a tile take
    the second launch."""
    assert scan_plan(c, 5) == (rows, 31 > rows)
    assert scan_plan(c, 0) == (rows, False)
    assert scan_plan(c, 12) == (rows, True)
