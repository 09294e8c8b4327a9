"""The pair warp's destination-row window (the SP mode of K1 and K5), on
the CPU.

``pallas_pair_warp(..., dest_row_start, dest_row_tiles)`` computes only
the rows ``[start, start + tiles) * 32`` of every warped map, reading
the whole source: the spatial-partitioning island's shard of the warp.
The port carries it in the plain twin (the whole warp, sliced), the
wrapper, the tile kernel and the resident kernel (``csrc/pair_warp.cu``:
``row0`` / ``rows``).

* The twin's window against the Pallas kernel's window in interpret mode
  (the tile body, and the resident body with ``variant="resident"``) and
  the JAX oracle's rows, at h = 64 and 96, 1-3 tiles, every receiver and
  the ego alone, float32 at 1e-4 (the pair warp's bar).
* The window equals the whole twin's rows bit for bit, and so does the
  emulation of the tile kernel's window (``tile_kernel_emulation`` of
  ``test_torch_pair_warp_roi.py``: planned at global rows, stored at
  window rows) on the spread poses and the 222nd draw, where the Pallas
  kernel's own skip zeroes a tile of the window that the oracle fills.
* The emulation of the resident kernel's window
  (``resident_kernel_emulation``: the Pallas kernel's ``pvalid`` over
  the window's tiles, every band staged, stores at window rows) on the
  same draws: a pair is skipped iff no tile of the window is in view,
  and the window equals the whole twin's rows bit for bit.
* A window past the map, on a map whose h is not a multiple of 32, half
  given, or on the previous body raises ``ValueError``; the operation
  count covers the window's rows only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops import fused_warp as jfw
from hmvit_tpu_torch.ops import fused_warp as pfw
from hmvit_tpu_torch.ops import opcount
from test_torch_pair_warp_roi import (
    resident_kernel_emulation,
    spread_draws,
    tile_kernel_emulation,
)
from torch_parity import close, rigid_pairwise, t

WARP_ATOL = 1e-4  # the pair warp's bar (ROADMAP.md "Tolerances")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def case(seed, h, l=3, c=8):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((1, 2, l, h, h, c)).astype(np.float32)
    pair = rigid_pairwise(rng, 1, l, max_t=20.0)
    mode = rng.integers(0, 2, (1, l)).astype(np.int32)
    return src, pair, mode


WINDOWS = [(64, 1, 1), (96, 1, 2), (96, 0, 3)]


@pytest.mark.parametrize("h,start,tiles", WINDOWS)
@pytest.mark.parametrize("receivers", [None, 1])
def test_window_matches_pallas_window_and_oracle(h, start, tiles, receivers):
    window_case(h, start, tiles, receivers, "auto")


@pytest.mark.parametrize("h,start,tiles", WINDOWS)
@pytest.mark.parametrize("receivers", [None, 1])
def test_resident_window_matches_pallas_resident_window(h, start, tiles,
                                                        receivers):
    """K5's window: the port's ``variant="resident"`` window against the
    Pallas resident body's window in interpret mode."""
    window_case(h, start, tiles, receivers, "resident")


def window_case(h, start, tiles, receivers, variant):
    src, pair, mode = case(h + start + tiles, h)
    assert pfw.resolve_variant(variant, h, h) == (
        "tile" if variant == "auto" else variant)
    got = pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0, receivers,
                              variant=variant, dest_row_start=start,
                              dest_row_tiles=tiles).numpy()
    pallas = np.asarray(jfw.pallas_pair_warp(
        jnp.asarray(src), jnp.asarray(pair), jnp.asarray(mode), 1.0, 1.0,
        interpret=True, num_receivers=receivers,
        dest_row_start=jnp.asarray([start], jnp.int32),
        dest_row_tiles=tiles, variant=variant))
    oracle = np.asarray(jfw.pair_warp_xla(
        jnp.asarray(src), jnp.asarray(pair), jnp.asarray(mode), 1.0, 1.0,
        receivers))[:, :, :, start * 32:(start + tiles) * 32]
    r = 3 if receivers is None else receivers
    assert got.shape == pallas.shape == (1, r, 3, tiles * 32, h, 8)
    close(got, pallas, WARP_ATOL)
    close(got, oracle, WARP_ATOL)
    # the window is the whole twin's rows, bit for bit
    full = pfw.pair_warp_xla(t(src), t(pair), t(mode), 1.0, 1.0,
                             receivers).numpy()
    np.testing.assert_array_equal(got, full[:, :, :, start * 32:
                                            (start + tiles) * 32])


@pytest.mark.parametrize("size,start,tiles", [(64, 1, 1), (96, 1, 2)])
def test_window_on_spread_draws_equals_whole_rows(size, start, tiles):
    """20 spread draws (+-pi, +-90 px): the window's rows of the twin equal
    the whole twin's, and on one draw so do the rows of the tile kernel's
    emulation (against the JAX oracle, spread poses are held to a derived
    bound, not 1e-4: ``chip_smoke.warp_fp32_bound``)."""
    src, pair = spread_draws(20, seed=5, size=size)
    mode = np.zeros((20, 2), np.int32)
    rows = slice(start * 32, (start + tiles) * 32)
    got = pfw.pair_warp_xla(t(src), t(pair), t(mode), 1.0, 1.0,
                            dest_row_start=start, dest_row_tiles=tiles)
    full = pfw.pair_warp_xla(t(src), t(pair), t(mode), 1.0, 1.0)
    assert torch.equal(got, full[:, :, :, rows])
    d = 3
    coef, rtype = pfw._prep_affines(t(pair[d:d + 1]), t(mode[d:d + 1]),
                                    (size, size), 1.0, 1.0)
    win = tile_kernel_emulation(t(src[d:d + 1]), coef, rtype, 2,
                                row0=start * 32, rows=tiles * 32)
    twin = torch.where(torch.isnan(full[d]), 0.0, full[d])
    for n in range(2):  # identity pairs: the kernel copies the map
        twin[n, n] = t(src)[d, 0, n]
    assert torch.equal(win, twin[:, :, rows])


def test_window_on_draw_222():
    """The 222nd draw: the Pallas tile kernel's skip zeroes (receiver 1,
    sender 0, xt 0, yt 1), the first tile of window (1, 1), which the
    oracle fills; the port's window, twin and kernel emulation, keeps the
    oracle's values."""
    src, pair = spread_draws(222)
    src, pair = src[-1:], pair[-1:]
    mode = np.zeros((1, 2), np.int32)
    got = pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0,
                              dest_row_start=1, dest_row_tiles=1)
    oracle = np.asarray(jfw.pair_warp_xla(
        jnp.asarray(src), jnp.asarray(pair), jnp.asarray(mode), 1.0,
        1.0))[:, :, :, 32:64]
    close(got.numpy(), oracle, WARP_ATOL)
    pallas = np.asarray(jfw.pallas_pair_warp(
        jnp.asarray(src), jnp.asarray(pair), jnp.asarray(mode), 1.0, 1.0,
        interpret=True, dest_row_start=jnp.asarray([1], jnp.int32),
        dest_row_tiles=1))
    assert np.abs(pallas[0, 1, 0, :, 0:32]).max() == 0  # JAX's skip
    assert np.abs(got[0, 1, 0, 0, 0].numpy()).max() > 0.01
    coef, rtype = pfw._prep_affines(t(pair), t(mode), (64, 64), 1.0, 1.0)
    win = tile_kernel_emulation(t(src), coef, rtype, 2, row0=32, rows=32)
    twin = got[0].clone()
    for n in range(2):
        twin[n, n] = t(src)[0, 0, n, 32:64]
    assert torch.equal(win, twin)


@pytest.mark.parametrize("h,start,tiles", [
    (64, 2, 1),   # past the map
    (64, 1, 2),   # runs past the map
    (64, -1, 1),
    (64, 0, 0),
    (80, 0, 1),   # h not a multiple of 32
])
def test_window_outside_the_map_raises(h, start, tiles):
    src, pair, mode = case(0, h, l=2)
    with pytest.raises(ValueError, match="does not fit"):
        pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0,
                            dest_row_start=start, dest_row_tiles=tiles)
    with pytest.raises(ValueError, match="does not fit"):
        pfw.pair_warp_launch(t(src), t(pair), t(mode), 1.0, 1.0,
                             dest_row_start=start, dest_row_tiles=tiles)


@pytest.mark.parametrize("what", ["half given", "resident", "previous"])
def test_window_half_given_resident_and_previous_raise(what):
    """A half-given window and a window on the previous body raise; a
    window on the resident variant runs (K5's window) and gives the tile
    variant's window."""
    src, pair, mode = case(0, 64, l=2)
    args = (t(src), t(pair), t(mode), 1.0, 1.0)
    if what == "half given":
        with pytest.raises(ValueError, match="go together"):
            pfw.fused_pair_warp(*args, dest_row_start=0)
        with pytest.raises(ValueError, match="go together"):
            pfw.pair_warp_launch(*args, variant="resident",
                                 dest_row_tiles=1)
    elif what == "resident":
        got = pfw.fused_pair_warp(*args, variant="resident",
                                  dest_row_start=1, dest_row_tiles=1)
        want = pfw.fused_pair_warp(*args, variant="tile", dest_row_start=1,
                                   dest_row_tiles=1)
        assert got.shape == (1, 2, 2, 32, 64, 8)
        assert torch.equal(got, want)
        _, out = pfw.pair_warp_launch(*args, variant="resident",
                                      dest_row_start=1, dest_row_tiles=1)
        assert out.shape == got.shape
    else:
        with pytest.raises(ValueError, match="previous body"):
            pfw.pair_warp_launch(*args, previous=True, dest_row_start=0,
                                 dest_row_tiles=1)


@pytest.mark.parametrize("size,start,tiles", [(64, 1, 1), (96, 1, 2),
                                              (96, 0, 1)])
def test_resident_window_emulation_on_spread_draws(size, start, tiles):
    """The resident kernel's window, emulated on 20 spread draws: the
    pairs it skips are those with no 32 x 32 tile of the window in view
    (JAX's ``pvalid`` over the window's tiles), among them pairs that
    the whole map stages, and every window equals the whole twin's rows
    bit for bit."""
    src, pair = spread_draws(20, seed=5, size=size)
    mode = np.zeros((20, 2), np.int32)
    row0, rows = start * 32, tiles * 32
    full = pfw.pair_warp_xla(t(src), t(pair), t(mode), 1.0, 1.0)
    window_skips = whole_skips = 0
    for d in range(len(src)):
        coef, rtype = pfw._prep_affines(t(pair[d:d + 1]), t(mode[d:d + 1]),
                                        (size, size), 1.0, 1.0)
        win, _, staged = resident_kernel_emulation(t(src[d:d + 1]), coef,
                                                   rtype, 2, row0, rows)
        valid = pfw.roi_tile_valid(coef, size)
        for n in range(2):
            for j in range(2):
                in_view = bool(valid[n, j, :, start:start + tiles].any())
                warp = bool(coef[n, j, 7] == 0)
                assert staged[n * 2 + j] == (warp and in_view)
                window_skips += warp and not in_view
                whole_skips += warp and not bool(valid[n, j].any())
        twin = torch.where(torch.isnan(full[d]), 0.0, full[d])
        for n in range(2):  # identity pairs: the kernel copies the map
            twin[n, n] = t(src)[d, 0, n]
        assert torch.equal(win, twin[:, :, row0:row0 + rows])
    assert window_skips > whole_skips, (window_skips, whole_skips)


def test_resident_window_emulation_on_draw_222():
    """The 222nd draw through the resident kernel's window emulation:
    (receiver 1, sender 0) is staged (its window tiles are in view by the
    port's conservative test), and the window keeps the oracle's values
    where the Pallas tile kernel's own skip zeroes them."""
    src, pair = spread_draws(222)
    src, pair = src[-1:], pair[-1:]
    mode = np.zeros((1, 2), np.int32)
    coef, rtype = pfw._prep_affines(t(pair), t(mode), (64, 64), 1.0, 1.0)
    win, _, staged = resident_kernel_emulation(t(src), coef, rtype, 2, 32,
                                               32)
    assert staged[2]  # pair (1, 0)
    want = pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0,
                               variant="resident", dest_row_start=1,
                               dest_row_tiles=1)[0].clone()
    for n in range(2):
        want[n, n] = t(src)[0, 0, n, 32:64]
    assert torch.equal(win, want)
    assert float(win[1, 0, 0, 0].abs().max()) > 0.01


def test_window_counts_its_rows_and_backpropagates():
    src, pair, mode = case(1, 64)
    with opcount.record_kernel_ops() as calls:
        pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0, 1,
                            dest_row_start=1, dest_row_tiles=1)
    assert calls == [("pair_warp", opcount.pair_warp_ops(1, 3, 32, 64, 8))]
    s = t(src).requires_grad_()
    pfw.fused_pair_warp(s, t(pair), t(mode), 1.0, 1.0, dest_row_start=1,
                        dest_row_tiles=1).sum().backward()
    s2 = t(src).requires_grad_()
    pfw.pair_warp_xla(s2, t(pair), t(mode), 1.0,
                      1.0)[:, :, :, 32:].sum().backward()
    assert torch.equal(s.grad, s2.grad)
