"""Port parity: dense-grid expansion of compacted per-pillar rows.  The
port's two functions (their plain version here, on CPU tensors) and the
plain version itself against the JAX package's Pallas kernels in
interpret mode (v1, v2) and its searchsorted + gather oracle, float32
and bfloat16, ``atol=0``: pure placement, so everything is equal bit for
bit.  4 x 4096 cells with an empty block, a fully dense block and a run
across a block boundary (the cases of tests/test_voxelize.py), fill rows
behind the real ones, M = 0, and grids that are no multiple of 4096 or
128 cells, which the port's functions take like any other (the JAX
package sends those to its oracle)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops import expand as jexpand
from hmvit_tpu_torch.ops import cuda
from hmvit_tpu_torch.ops import expand as pexpand
from torch_parity import t

BLOCK = jexpand.BLOCK
SUB = jexpand.SUB
NUM_CELLS = 4 * BLOCK
PORT_FNS = {"v1": pexpand.expand_rows_to_dense,
            "v2": pexpand.expand_rows_to_dense_v2,
            "plain": pexpand.expand_rows_to_dense_plain}
JAX_FNS = {
    "pallas_v1": lambda c, i: jexpand.expand_rows_to_dense(
        c, i, NUM_CELLS, interpret=True),
    "pallas_v2": lambda c, i: jexpand.expand_rows_to_dense_v2(
        c, i, NUM_CELLS, interpret=True),
    "oracle": lambda c, i: jexpand.expand_rows_to_dense_xla(c, i, NUM_CELLS),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rows(fill: int = 0, c: int = 64):
    rng = np.random.default_rng(13)
    ids = np.unique(np.concatenate([
        rng.integers(0, BLOCK, 60),
        np.arange(BLOCK, 2 * BLOCK),                # a fully dense block
        np.arange(3 * BLOCK - 70, 3 * BLOCK + 70),  # across a boundary
    ])).astype(np.int32)                            # most of block 2: empty
    ids = np.concatenate([ids, np.full(fill, NUM_CELLS, np.int32)])
    return ids, rng.normal(size=(len(ids), c)).astype(np.float32)


def test_constants_match_the_jax_package():
    assert (pexpand.BLOCK, pexpand.SUB) == (jexpand.BLOCK, jexpand.SUB)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reference", sorted(JAX_FNS))
def test_port_equals_jax(reference, dtype):
    ids, comp = _rows(fill=0 if reference == "pallas_v1" else 24)
    jcomp = jnp.asarray(comp).astype(dtype)
    want = np.asarray(JAX_FNS[reference](jcomp, jnp.asarray(ids)).astype(
        jnp.float32))
    tcomp = t(comp).to(getattr(torch, dtype))
    real = ids[ids < NUM_CELLS]
    for name, fn in PORT_FNS.items():
        got = fn(tcomp, t(ids), NUM_CELLS)
        assert got.dtype == tcomp.dtype and got.shape == (NUM_CELLS, 64)
        np.testing.assert_allclose(got.float().numpy(), want, atol=0,
                                   err_msg=name)
        assert torch.equal(got[t(real).long()], tcomp[:len(real)])
        empty = np.setdiff1d(np.arange(NUM_CELLS), real)
        assert not got[t(empty)].any()


@pytest.mark.parametrize("name", sorted(PORT_FNS))
def test_no_rows_gives_zeros(name):
    out = PORT_FNS[name](torch.zeros(0, 8), torch.zeros(0, dtype=torch.int32),
                         NUM_CELLS)
    assert out.shape == (NUM_CELLS, 8) and not out.any()


@pytest.mark.parametrize("num_cells", [5000, 704 * 200])
@pytest.mark.parametrize("name", sorted(PORT_FNS))
def test_other_grids_equal_the_jax_oracle(name, num_cells):
    """A grid that is no multiple of 4096 (nor of 128) cells: rows at the
    first cell, at both sides of a block boundary, at the last cell, and
    fill rows behind them."""
    ids = np.asarray([0, 7, 4095, 4096, num_cells - 1, num_cells, num_cells],
                     np.int32)
    comp = np.random.default_rng(0).normal(size=(7, 16)).astype(np.float32)
    want = np.asarray(jexpand.expand_rows_to_dense_xla(
        jnp.asarray(comp), jnp.asarray(ids), num_cells))
    got = PORT_FNS[name](t(comp), t(ids), num_cells)
    assert got.shape == (num_cells, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=0)


@pytest.mark.parametrize("v2", [False, True])
def test_a_cuda_tensor_never_takes_the_plain_version(v2, monkeypatch):
    """What decides between kernel and plain version is the tensor's
    device (or ``plain_ops()``), never the grid: with the decision forced
    to "kernel", a grid of 5000 cells goes to the launcher, whose launch
    on these CPU tensors raises."""
    ids = np.asarray([0, 7, 4095, 4999, 5000, 5000], np.int32)
    comp = np.zeros((6, 16), np.float32)
    monkeypatch.setattr(pexpand, "use_kernel", lambda x: True)
    monkeypatch.setattr(
        pexpand, "expand_rows_to_dense_plain",
        lambda *a: pytest.fail("the plain version ran"))
    fn = pexpand.expand_rows_to_dense_v2 if v2 else pexpand.expand_rows_to_dense
    before = cuda.launch_counts()
    with pytest.raises(ValueError):
        fn(t(comp), t(ids), 5000)
    assert cuda.launch_counts() == before


@pytest.mark.parametrize("num_cells", [NUM_CELLS, NUM_CELLS - 1000])
@pytest.mark.parametrize("v2", [False, True])
def test_launcher_builds_the_tables_and_refuses_the_cpu(v2, num_cells):
    """``r0`` / ``r0s``: the first row at or after each (sub-)block start,
    one entry per started (sub-)block and a last one for ``num_cells``
    (a short last block ends there).  Laying a launch out needs no card;
    launching on CPU tensors raises and counts nothing."""
    ids, comp = _rows(fill=24, c=125 + 3)  # wider than the JAX v2 limit
    ids = np.sort(np.minimum(ids, num_cells))  # cells past the grid: fill
    seen = {}
    kernel = cuda.EXPAND_ROWS_V2 if v2 else cuda.EXPAND_ROWS

    def spy(tensors, ints):
        seen["tensors"], seen["ints"] = tensors, ints
        raise ValueError("no card")

    launch, out = pexpand.expand_rows_launch(t(comp), t(ids), num_cells, v2)
    assert out.shape == (num_cells, 128)
    real_launch, kernel.launch = kernel.launch, spy
    try:
        with pytest.raises(ValueError):
            launch()
    finally:
        kernel.launch = real_launch
    _, got_ids, table, _ = seen["tensors"]
    step = pexpand.SUB if v2 else pexpand.BLOCK
    starts = np.minimum(np.arange(-(-num_cells // step) + 1) * step,
                        num_cells)
    assert table.dtype == torch.int32 and got_ids.dtype == torch.int32
    assert np.array_equal(table.numpy(), np.searchsorted(ids, starts))
    assert seen["ints"] == [128 * 4, num_cells]
    before = kernel.launches
    with pytest.raises(ValueError):
        launch()
    assert kernel.launches == before
    with pytest.raises(RuntimeError, match="forward only"):
        pexpand.expand_rows_launch(t(comp).requires_grad_(), t(ids),
                                   num_cells, v2)


# -- the CUDA kernels' row-location scheme, emulated on the CPU ----------
# csrc/expand.cu: a thread block owns a slice of SLICE cells; v1 takes the
# slice's first and last rows from r0 at its 4096-cell block's ends and
# otherwise from one warp's 32-probe search inside [r0[b], r0[b + 1]); v2
# reads them from r0s; rows enter a cell -> row map when they are the
# first of their id (i == first or ids[i - 1] != ids[i]); every cell of
# the slice is then written once, from its row or zero.  Change the
# kernel's scheme and this emulation together.
SLICE = 256


def warp_lower_bound(ids, lo, hi, target):
    """``warp_lower_bound`` of csrc/expand.cu: (lower bound of target in
    ids[lo, hi), dependent rounds of 32 probes taken)."""
    rounds = 0
    while lo < hi:
        step = (hi - lo + 31) >> 5
        idx = lo + np.arange(32) * step
        below = (idx < hi) & (ids[np.minimum(idx, len(ids) - 1)] < target)
        n = int(below.sum())
        assert below[:n].all()  # a ballot of sorted ids is a prefix
        rounds += 1
        if n == 0:
            return lo, rounds
        hi = min(hi, lo + n * step)
        lo += (n - 1) * step + 1
    return lo, rounds


def slice_rows(ids, table, s, num_cells, v2):
    """The rows [first, last) of slice ``s`` as the kernel finds them,
    and the most search rounds it took."""
    if v2:
        subs = -(-num_cells // SUB)
        per = SLICE // SUB
        return (int(table[min(s * per, subs)]),
                int(table[min(s * per + per, subs)]), 0)
    per = BLOCK // SLICE
    b, k = divmod(s, per)
    lo, hi = int(table[b]), int(table[b + 1])
    first, r1 = (lo, 0) if k == 0 else warp_lower_bound(ids, lo, hi,
                                                         s * SLICE)
    last, r2 = (hi, 0) if k + 1 == per else warp_lower_bound(
        ids, lo, hi, (s + 1) * SLICE)
    return first, last, max(r1, r2)


def kernel_emulation(comp, ids, num_cells, v2):
    """(out, most search rounds): the kernel's output on torch tensors,
    every cell written exactly once (checked)."""
    ids = np.asarray(ids)
    step = SUB if v2 else BLOCK
    starts = np.minimum(np.arange(-(-num_cells // step) + 1) * step,
                        num_cells)
    table = np.searchsorted(ids, starts)  # the wrapper's table
    out = torch.empty((num_cells, comp.shape[1]), dtype=comp.dtype)
    written = np.zeros(num_cells, np.int64)
    rounds = 0
    zero = torch.zeros(comp.shape[1], dtype=comp.dtype)
    for s in range(-(-num_cells // SLICE)):
        cell0 = s * SLICE
        cells = min(SLICE, num_cells - cell0)
        first, last, r = slice_rows(ids, table, s, num_cells, v2)
        rounds = max(rounds, r)
        row_of = np.full(SLICE, -1)
        for i in range(first, last):
            cell = int(ids[i]) - cell0
            if 0 <= cell < cells and (i == first or ids[i - 1] != ids[i]):
                assert row_of[cell] < 0  # no two rows race for a cell
                row_of[cell] = i
        for cell in range(cells):
            out[cell0 + cell] = comp[row_of[cell]] if row_of[cell] >= 0 \
                else zero
            written[cell0 + cell] += 1
    assert (written == 1).all()
    return out, rounds


def _repeated_rows(num_cells, c=8, seed=3):
    """Sorted ids with runs of repeats (1-4 rows an id), one of them at
    the first cell of a slice and one at the last cell of a block, a
    fully occupied block crossed by slice boundaries where the grid has
    one, and fill rows behind them."""
    rng = np.random.default_rng(seed)
    cells = rng.choice(num_cells, size=min(num_cells // 3, 2000),
                       replace=False)
    extra = [SLICE, min(BLOCK, num_cells) - 1, num_cells - 1]
    if num_cells >= 2 * BLOCK:
        extra += list(range(BLOCK, 2 * BLOCK))
    cells = np.unique(np.concatenate([cells, extra]))
    ids = np.repeat(cells, rng.integers(1, 5, len(cells)))
    ids = np.concatenate([ids, np.full(17, num_cells)]).astype(np.int32)
    comp = rng.normal(size=(len(ids), c)).astype(np.float32)
    return ids, comp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("v2", [False, True])
@pytest.mark.parametrize("case", ["four blocks", "repeated ids",
                                  "704 x 200 repeated", "short last block",
                                  "no rows"])
def test_kernel_scheme_equals_the_jax_oracle(case, v2, dtype):
    """The kernels' row location (slice start from r0 or r0s, the warp
    search, the first-of-run map) emulated on the CPU, bit for bit equal
    to the JAX oracle ``expand_rows_to_dense_xla``: unique ids with a
    dense block and a run across a block boundary, repeated ids (the
    first row is placed), the 704 x 200 grid, a short last block and
    sub-block, no rows.  With unique ids a search takes at most 3
    rounds."""
    if case == "four blocks":
        num_cells = NUM_CELLS
        ids, comp = _rows(fill=24, c=16)
    elif case == "no rows":
        num_cells = 5000
        ids, comp = np.zeros(0, np.int32), np.zeros((0, 8), np.float32)
    else:
        num_cells = {"repeated ids": NUM_CELLS, "704 x 200 repeated":
                     704 * 200, "short last block": BLOCK + SUB + 1}[case]
        ids, comp = _repeated_rows(num_cells)
    want = np.asarray(jexpand.expand_rows_to_dense_xla(
        jnp.asarray(comp).astype(dtype), jnp.asarray(ids), num_cells)
        .astype(jnp.float32)) if len(ids) else np.zeros(
            (num_cells, comp.shape[1]), np.float32)
    tcomp = t(comp).to(getattr(torch, dtype))
    got, rounds = kernel_emulation(tcomp, ids, num_cells, v2)
    np.testing.assert_allclose(got.float().numpy(), want, atol=0)
    assert torch.equal(got, pexpand.expand_rows_to_dense_plain(
        tcomp, t(ids), num_cells))
    if case == "four blocks":
        assert rounds == (0 if v2 else 3)
    if "repeated" in case:
        first = np.searchsorted(ids, ids[:-17])  # each id's first row
        assert (first != np.arange(len(ids) - 17)).any()
        real = ids < num_cells
        assert torch.equal(got[t(ids[real]).long()], tcomp[first])


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4096, 20000])
def test_warp_search_is_a_lower_bound(n):
    """The warp's 32-probe search equals searchsorted(side='left') on any
    range, with repeats, at every target from below to above the range,
    in ceil(log32 n) rounds or one more."""
    rng = np.random.default_rng(n)
    ids = np.sort(rng.integers(0, 3 * n, n)).astype(np.int32)
    for target in np.unique(np.concatenate([ids, ids + 1, [-1, 3 * n + 1]])):
        got, rounds = warp_lower_bound(ids, 0, n, int(target))
        assert got == np.searchsorted(ids, target, side="left")
        assert rounds <= int(np.ceil(np.log(n) / np.log(32))) + 1
