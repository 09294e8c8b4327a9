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
