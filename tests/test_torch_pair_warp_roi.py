"""The pair-warp kernels' ROI tile skip and index maps, on the CPU.

* ``roi_tile_valid`` (the port's form of the Pallas kernels' tile skip,
  the predicate of ``tile_in_view`` in ``csrc/warp_taps.cuh``) is
  conservative: over 300 seeded rigid poses and a set near 90 degrees,
  every tile it marks out of view is exactly zero in the twin.
* The draw on which the JAX package's own skip is not conservative
  (``_prep_affines`` takes the row margin as 1; the row coordinate is
  taken at the integer column tap, up to |v0| further): the Pallas tile
  kernel zeroes a tile the oracle fills, the port follows the oracle.
* An emulation of the two CUDA kernels' index maps — the tile kernel's
  blocks of (pair, strip of a 32 x 32 tile) in their grid order, the
  resident kernel's clusters of 8 blocks, each staging a band of rows of
  a channel slab and reading taps in other bands from their owners —
  with the kernels' tap arithmetic, reproduces the twin bit for bit in
  float32, on partial edge tiles and on taps across band edges.  Change
  the emulation with the kernels (``csrc/pair_warp.cu``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops import fused_warp as jfw
from hmvit_tpu_torch.ops import fused_warp as pfw
from torch_parity import rigid_pairwise, t

WARP_ATOL = 1e-4  # as tests/test_torch_warp.py: the frameworks' affine chains


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def spread_draws(count, seed=0, size=64, c=8):
    """``count`` draws of default_rng(seed), each: 2 agents at angles
    uniform in +-pi and positions uniform in +-90 px, then a (1, 1, 2,
    size, size, c) unit-normal source."""
    rng = np.random.default_rng(seed)
    pairs, srcs = [], []
    for _ in range(count):
        pairs.append(rigid_pairwise(rng, 1, 2, max_t=90.0))
        srcs.append(rng.normal(size=(1, 1, 2, size, size, c))
                    .astype(np.float32))
    return np.concatenate(srcs), np.concatenate(pairs)


def tile_nonzero(out, tile=32):
    """(..., XT, YT): which tile x tile tiles of (..., S, S, C) maps hold
    any non-zero value."""
    *lead, s, _, c = out.shape
    n = s // tile
    z = (out != 0).reshape(*lead, n, tile, n, tile, c)
    return z.any(-1).any(-1).any(-2).transpose(-1, -2)


def near_90_draws(count, seed=7):
    rng = np.random.default_rng(seed)
    angles = np.pi / 2 * rng.choice([-1.0, 1.0], (count, 2)) \
        + rng.uniform(-2e-3, 2e-3, (count, 2))
    pairs = [rigid_pairwise(rng, 1, 2, max_t=90.0, angles=a) for a in angles]
    src = rng.normal(size=(count, 1, 2, 64, 64, 8)).astype(np.float32)
    return src, np.concatenate(pairs)


@pytest.mark.parametrize("draws", ["spread", "near_90deg"])
def test_roi_tile_valid_is_conservative(draws):
    """Every tile marked out of view is exactly zero in the twin, for
    every (receiver, sender) pair; identity pairs are in view."""
    src, pair = spread_draws(300) if draws == "spread" else near_90_draws(40)
    mode = torch.zeros(len(src), 2, dtype=torch.int64)
    out = pfw.pair_warp_xla(t(src), t(pair), mode, 1.0, 1.0)
    coef = pfw.pair_warp_coefficients(t(pair), (64, 64), 1.0, 1.0)
    valid = pfw.roi_tile_valid(coef, 64)
    nz = tile_nonzero(out)
    assert valid.shape == nz.shape == (len(src), 2, 2, 2, 2)
    assert not bool((~valid & nz).any())
    assert bool(valid[:, [0, 1], [0, 1]].all())  # i == j: copies
    skipped = int((~valid).sum())
    if draws == "spread":
        assert skipped > 1500  # the skip is worth having on spread poses
    # the skip is tight: few tiles in view are zero
    assert int((valid & ~nz).sum()) <= 0.05 * valid.numel()


def test_roi_tile_valid_marks_invalid_pairs_and_partial_tiles():
    src, pair = spread_draws(1)
    pair = pair.copy()
    pair[0, 1, 0] = np.nan  # sender 1 -> receiver 0 broken
    coef = pfw.pair_warp_coefficients(t(pair), (50, 50), 1.0, 1.0)
    valid = pfw.roi_tile_valid(coef, 50)
    assert valid.shape == (1, 2, 2, 2, 2)
    assert not bool(valid[0, 0, 1].any())
    out = pfw.pair_warp_xla(t(src[..., :50, :50, :]), t(pair),
                            torch.zeros(1, 2, dtype=torch.int64), 1.0, 1.0)
    padded = torch.zeros(1, 2, 2, 64, 64, 8)
    padded[..., :50, :50, :] = out
    assert not bool((~valid & tile_nonzero(padded)).any())


def test_oracle_fault_draw_222():
    """The 222nd draw of default_rng(0): receiver 1, sender 0, tile (xt 0,
    yt 1).  JAX's _prep_affines marks it out of view and the Pallas tile
    kernel writes zeros there; the oracle pair_warp_xla does not, and
    neither does the port's twin (within the oracle bar) nor its skip."""
    src, pair = spread_draws(222)
    src, pair = src[-1:], pair[-1:]
    mode = np.zeros((1, 2), np.int32)
    got = pfw.pair_warp_xla(t(src), t(pair), t(mode), 1.0, 1.0).numpy()
    oracle = np.asarray(jfw.pair_warp_xla(
        jnp.asarray(src), jnp.asarray(pair), jnp.asarray(mode), 1.0, 1.0))
    np.testing.assert_allclose(got, oracle, atol=WARP_ATOL, rtol=0)
    coef = pfw.pair_warp_coefficients(t(pair), (64, 64), 1.0, 1.0)
    assert bool(pfw.roi_tile_valid(coef, 64)[0, 1, 0, 0, 1])
    _, origins, _ = jfw._prep_affines(jnp.asarray(pair), jnp.asarray(mode),
                                      (64, 64), 1.0, 1.0)
    assert int(origins[1, 0, 0, 1, 2]) == 0  # JAX: out of view
    # the tile holds the warped map's values, pixel (y 32, x 0) among them
    assert np.abs(got[0, 1, 0, 32:64, 0:32]).max() > 0
    assert np.abs(got[0, 1, 0, 32, 0]).max() > 0.01


# -- the kernels' index maps, emulated ----------------------------------------

TILE_W, STRIP_H = 32, 2   # pair_warp.cu: kTileW, kStripH
WARPS = 8                 # pair_warp.cu: kTileThreads / 32
CLUSTER = 8               # the resident kernel's blocks a cluster
V = 4                     # float32 channels in a 16-byte vector


def fma(a, b, c):
    """__fmaf_rn in float32: the product is exact in float64."""
    return (a.double() * b.double() + c.double()).float()


def hat(coord, cell):
    return torch.clamp(1.0 - (coord - cell).abs(), min=0.0)


def plan_taps(cf, x, y, size):
    """warp_taps.cuh::plan_taps for pixel tensors x, y of one pair:
    (pix (..., 2, 2) with -1 for no tap, w1 (..., 2, 2), w2 (..., 2),
    flag) with the kernel's float32 operations in its order."""
    m00, m01, tx, v0, v1, tya = (cf[k] for k in range(6))
    swap = bool(cf[6] > 0.5)
    flag = 2 if cf[7] > 1.5 else 1 if cf[7] > 0.5 else 0
    xf, yf = x.float(), y.float()
    cc = (m00 * xf + m01 * yf) + tx
    c0 = torch.floor(cc)
    pix = torch.full((*x.shape, 2, 2), -1, dtype=torch.int64)
    w1 = torch.zeros((*x.shape, 2, 2))
    w2 = torch.zeros((*x.shape, 2))
    for dc in range(2):
        ccell = c0 + dc
        wc = hat(cc, ccell)
        ok_c = (wc != 0) & (ccell >= 0) & (ccell < size)
        w2[..., dc] = torch.where(ok_c, wc, 0.0)
        rc = (v1 * yf + v0 * ccell) + tya
        r0 = torch.floor(rc)
        for dr in range(2):
            rcell = r0 + dr
            wr = hat(rc, rcell)
            ok = ok_c & (wr != 0) & (rcell >= 0) & (rcell < size)
            ci, ri = ccell.long(), rcell.long()
            p = ci * size + ri if swap else ri * size + ci
            w1[..., dc, dr] = torch.where(ok, wr, 0.0)
            pix[..., dc, dr] = torch.where(ok, p, -1)
    return pix, w1, w2, flag


def warp_vectors(plan, load, self_pix):
    """warp_taps.cuh::warp_vec16 in float32 on a batch of vectors:
    load(pix) -> (..., V) source values (pix >= 0)."""
    pix, w1, w2, flag = plan
    if flag == 2:
        return torch.zeros((*self_pix.shape, V))
    if flag == 1:
        return load(self_pix)
    acc = torch.zeros((*self_pix.shape, V))
    for dc in range(2):
        tmp = torch.zeros_like(acc)
        for dr in range(2):
            p = pix[..., dc, dr]
            v = load(p.clamp(min=0))
            tmp = torch.where((p >= 0)[..., None],
                              fma(w1[..., dc, dr, None], v, tmp), tmp)
        acc = torch.where((w2[..., dc] != 0)[..., None],
                          fma(w2[..., dc, None], tmp, acc), acc)
    return acc


def warp_walk(npx, cvecs):
    """pair_warp_kernel's walk of a strip: (pixel, vector) of every 16-byte
    store, warp by warp and lane by lane — a warp takes pps pixels at
    once, lpp lanes each, and a lane two vectors lpp apart a step."""
    lpp = min(cvecs, 32)
    pps = 32 // lpp
    done = []
    for warp in range(WARPS):
        for lane in range(32):
            sub = lane // lpp
            if sub >= pps:
                continue
            for p in range(warp * pps + sub, npx, WARPS * pps):
                for v in range(lane - sub * lpp, cvecs, 2 * lpp):
                    done += [(p, u) for u in (v, v + lpp) if u < cvecs]
    return torch.tensor(done).T


def tile_kernel_emulation(src, coef, rtype, n_recv, row0=0, rows=None):
    """pair_warp_kernel: blocks (b, j, strip, r) in grid order, each
    planning its strip's pixels (zeros out of view), then its warps'
    walk (:func:`warp_walk`), over the destination rows [row0, row0 +
    rows) (the whole map by default; the output holds those rows).
    Every output element is written exactly once (checked)."""
    bsz, ty, nj, size, _, c = src.shape
    rows = size if rows is None else rows
    n_pairs = coef.shape[0]
    out = torch.full((n_pairs, nj, rows, size, c), float("nan"))
    flat = out.view(-1)
    written = torch.zeros(flat.numel(), dtype=torch.int64)
    tiles_x = -(-size // TILE_W)
    strips = tiles_x * -(-rows // STRIP_H)
    cvecs = c // V
    for block in range(bsz * nj * strips * n_recv):
        rest = block
        r, rest = rest % n_recv, rest // n_recv
        s, rest = rest % strips, rest // strips
        j, b = rest % nj, rest // nj
        n = b * n_recv + r
        sy = s // tiles_x
        x0, y0 = (s - sy * tiles_x) * TILE_W, row0 + sy * STRIP_H
        w, h = min(TILE_W, size - x0), min(STRIP_H, row0 + rows - y0)
        cf = coef[n, j]
        seen = bool(pfw.rect_in_view(cf, x0, y0, w, h, size))
        p = torch.arange(w * h)
        x, y = x0 + p % w, y0 + p // w
        plan = plan_taps(cf, x, y, size)
        if not seen:
            plan = (*plan[:3], 2)
        dst_pix = y * size + x
        pi, vi = warp_walk(w * h, cvecs)
        ch = vi * V
        amap = src[b, int(rtype[n]), j].reshape(size * size, c)
        vec_plan = (plan[0][pi], plan[1][pi], plan[2][pi], plan[3])
        vals = warp_vectors(
            vec_plan,
            lambda q: amap[q[..., None], ch[:, None] + torch.arange(V)],
            dst_pix[pi])
        at = (((n * nj + j) * rows * size + dst_pix[pi] - row0 * size) * c
              + ch)[:, None] + torch.arange(V)
        flat[at] = vals
        written[at] += 1
    assert bool((written == 1).all())
    return out


def div_small(q, d):
    """pair_warp.cu::div_small: q // d from a float32 estimate, corrected
    once each way."""
    inv = torch.tensor(1.0) / torch.tensor(float(d))
    k = (q.float() * inv).trunc().long()
    k = k - (k * d > q).long()
    return k + ((k + 1) * d <= q).long()


MAX_STAGE, ALIGN = 75776, 128  # pair_warp.cu: kMaxStageBytes, kAlign


def slab_channels(c, size):
    """pair_warp.cu::slab_channels in float32 channels: the widest slab
    of 64, 32 or 16 bytes that divides C and whose band fits."""
    band_pix = size // CLUSTER * size
    for nbytes in (64, 32, 16):
        if c % (nbytes // 4) == 0 and band_pix * nbytes + 8 + ALIGN \
                <= MAX_STAGE:
            return nbytes // 4
    raise ValueError(c)


def f32(x):
    return torch.tensor(x, dtype=torch.float32)


def tap_row(cf, size):
    """pair_warp.cu::tap_row: (a, b, c0, reach), the physical source row
    a destination pixel's taps lie about, a x' + b y' + c0."""
    m00, m01, tx, v0, v1, tya = (cf[k] for k in range(6))
    if cf[6] > 0.5:
        a, b, c0 = m00, m01, tx
    else:
        a, b, c0 = v0 * m00, v0 * m01 + v1, tya + v0 * tx
    mag = ((m00.abs() + m01.abs() + v0.abs() + v1.abs() + a.abs()
            + b.abs()) * (size + 1) + tx.abs() + tya.abs() + c0.abs()
           + (v0 * tx).abs())
    return a, b, c0, 2.0 + v0.abs() + 1e-3 + 1e-5 * mag


def src_block(tr, x, y, size):
    """The block that computes pixels (x, y), -1 where their taps lie off
    the map (pair_warp_resident_kernel's src_block)."""
    a, b, c0, reach = tr
    r = (a * x.float() + b * y.float()) + c0
    near = (r >= -reach) & (r < size + reach)
    blk = torch.floor(r * (f32(1.0) / f32(size // CLUSTER))).long()
    return torch.where(near, blk.clamp(0, CLUSTER - 1), -1)


def walk_lines(tr, rank, size, along_x, row0=0, rows=None):
    """The candidate pixels (x, y) of block `rank`'s walk: for each line o
    of the walk, the interval where the taps' row lies in the block's
    rows (widened by 0.01 and a pixel), clipped to the map and to the
    destination rows [row0, row0 + rows)."""
    rows = size if rows is None else rows
    a, b, c0, reach = tr
    band = size // CLUSTER
    inner = a if along_x else b
    lo = (-reach if rank == 0 else f32(rank * band)) - 0.01
    hi = (size + reach if rank == CLUSTER - 1
          else f32((rank + 1) * band)) + 0.01
    xs, ys = [], []
    lines = range(row0, row0 + rows) if along_x else range(size)
    i_lo, i_hi = (0, size) if along_x else (row0, row0 + rows)
    for o in lines:
        base = (b if along_x else a) * o + c0
        fa, fb = 0.0, size - 1.0
        if inner != 0:
            e1, e2 = (lo - base) / inner, (hi - base) / inner
            fa = max(fa, float(torch.floor(torch.minimum(e1, e2))) - 1.0)
            fb = min(fb, float(torch.ceil(torch.maximum(e1, e2))) + 1.0)
        elif not lo <= base < hi:
            fb = -1.0
        ia = max(int(min(fa, size)), i_lo)
        i = torch.arange(ia, max(ia, min(int(max(fb, -1.0)), i_hi - 1) + 1))
        xs.append(i if along_x else torch.full_like(i, o))
        ys.append(torch.full_like(i, o) if along_x else i)
    return torch.cat(xs), torch.cat(ys)


def resident_kernel_emulation(src, coef, rtype, n_recv, row0=0, rows=None):
    """pair_warp_resident_kernel: clusters (pair, slab), over the
    destination rows [row0, row0 + rows) (the whole map by default; the
    output holds those rows), whose pixels are cut into CLUSTER equal
    runs, each block's destination share.  A pair is staged when a 32 x
    32 tile of those rows is in view.  In a staged pair block `rank` holds
    source rows [rank * band, (rank + 1) * band) of the slab in its shared
    memory and computes the destination pixels whose taps' row falls
    there (each tap read from the block that owns its source row); the
    pixels whose taps lie off the map are zeros, written by the block of
    their destination share.  Pairs not staged: the destination share
    from device memory (a copy) or zeros.  Returns (the output, the taps
    read from another block's band, each pair's staging flag)."""
    bsz, ty, nj, size, _, c = src.shape
    rows = size if rows is None else rows
    n_pairs = coef.shape[0] * nj
    slab_ch = slab_channels(c, size)
    band = size // CLUSTER
    band_pix = band * size
    share = rows * size // CLUSTER
    svecs = slab_ch // V
    out = torch.full((n_pairs, rows, size, c), float("nan"))
    flat = out.view(-1)
    written = torch.zeros(flat.numel(), dtype=torch.int64)
    tiles = size // 32
    remote = 0
    staged_pairs = []
    for pair in range(n_pairs):
        n, j = pair // nj, pair % nj
        b = n // n_recv
        cf = coef[n, j]
        amap = src[b, int(rtype[n]), j].reshape(size * size, c)
        staged = bool(cf[7] <= 0.5) and bool(
            pfw.roi_tile_valid(cf, size)[:tiles, row0 // 32:(row0 + rows)
                                         // 32].any())
        staged_pairs.append(staged)
        tr = tap_row(cf, size)
        for slab in range(c // slab_ch):
            bands = torch.stack([
                amap[rank * band_pix:(rank + 1) * band_pix,
                     slab * slab_ch:(slab + 1) * slab_ch].reshape(-1)
                for rank in range(CLUSTER)])
            for rank in range(CLUSTER):
                pix = row0 * size + rank * share + torch.arange(share)
                y = div_small(pix, size)
                x = pix - y * size
                assert torch.equal(y, pix // size)
                jobs = []  # (x, y, load or None for zeros)
                if not staged:
                    plan = plan_taps(cf, x, y, size)
                    if cf[7] <= 0.5:
                        plan = (*plan[:3], 2)
                    jobs.append((x, y, plan, "device"))
                else:
                    cx, cy = walk_lines(tr, rank, size, bool(cf[6] <= 0.5),
                                        row0, rows)
                    mine = src_block(tr, cx, cy, size) == rank
                    cx, cy = cx[mine], cy[mine]
                    jobs.append((cx, cy, plan_taps(cf, cx, cy, size),
                                 "cluster"))
                    off = src_block(tr, x, y, size) < 0
                    jobs.append((x[off], y[off], None, "zeros"))
                for jx, jy, plan, how in jobs:
                    jpix = jy * size + jx
                    for v in range(svecs):
                        ch = slab * slab_ch + v * V
                        if how == "zeros":
                            vals = torch.zeros((len(jpix), V))
                        elif how == "device":
                            vals = warp_vectors(
                                plan, lambda p, ch=ch: amap[
                                    p[:, None], ch + torch.arange(V)], jpix)
                        else:
                            def load(sp, v=v):
                                nonlocal remote
                                owner = div_small(sp, band_pix)
                                assert torch.equal(owner, sp // band_pix)
                                remote += int((owner != rank).sum())
                                local = (sp - owner * band_pix) * slab_ch \
                                    + v * V
                                return bands[owner[:, None],
                                             local[:, None]
                                             + torch.arange(V)]
                            vals = warp_vectors(plan, load, jpix)
                        at = ((pair * rows * size + jpix - row0 * size) * c
                              + ch)[:, None] + torch.arange(V)
                        flat[at] = vals
                        written[at] += 1
    assert bool((written == 1).all())
    return out.reshape(coef.shape[0], nj, rows, size, c), remote, \
        staged_pairs


EMULATED = {
    # spread poses on a map with partial edge tiles and strips (50 = 32
    # + 18 columns, 12 strips of 4 rows and one of 2)
    "tile, 50 x 50 partial tiles": ("tile", 50, 8, 90.0, 5),
    "tile, 64 x 64 near": ("tile", 64, 12, 10.0, 6),
    # 40 vectors a pixel: a lane's second vector only on lanes 0-7
    "tile, 40 x 40, C = 160": ("tile", 40, 160, 30.0, 7),
    # bands of 8 rows: co-located poses read across every band edge
    "resident, 64 x 64, C = 24 (8-channel slabs)": ("resident", 64, 24,
                                                    10.0, 3),
    "resident, 64 x 64, C = 16, spread": ("resident", 64, 16, 60.0, 4),
    # the conditioning swap: the walk runs along y'
    "resident, 64 x 64, near 90 degrees": ("resident", 64, 8, 10.0, 8,
                                           [np.pi / 2 - 1e-3, 0.2,
                                            -np.pi / 2 + 2e-3]),
    # bands of 12 rows: 1 / 12 is not exact in float32, so div_small
    # corrects its estimate and the walk's band edges rest on their
    # margins
    "resident, 96 x 96, bands of 12 rows": ("resident", 96, 8, 10.0, 9),
    "resident, 96 x 96, near 90 degrees": ("resident", 96, 16, 30.0, 11,
                                           [-np.pi / 2 + 1e-3, 2.5,
                                            np.pi / 2 - 2e-3]),
    # bands of 20 rows and the 16-byte slab (a band of 32-byte slabs
    # does not fit)
    "resident, 160 x 160, bands of 20 rows": ("resident", 160, 8, 40.0,
                                              10),
}


@pytest.mark.parametrize("case", sorted(EMULATED))
def test_kernel_index_maps_reproduce_the_twin(case):
    kind, size, c, max_t, seed, *angles = EMULATED[case]
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((1, 2, 3, size, size, c)).astype(np.float32)
    pair = rigid_pairwise(rng, 1, 3, max_t=max_t,
                          angles=angles[0] if angles else None)
    pair[:, 2, 1] = np.nan  # sender 2 -> receiver 1: an invalid pair
    mode = np.array([[0, 1, 1]], np.int32)
    want = pfw.pair_warp_xla(t(src), t(pair), t(mode), 1.0, 1.0)
    coef, rtype = pfw._prep_affines(t(pair), t(mode), (size, size), 1.0,
                                    1.0)
    emulate = (tile_kernel_emulation if kind == "tile"
               else resident_kernel_emulation)
    got = emulate(t(src), coef, rtype, 3)
    if kind == "resident":
        got, remote, _ = got
        assert remote > 0  # some taps are read across a band edge
    want = torch.where(torch.isnan(want), 0.0, want)  # invalid -> zeros
    want = want.reshape(3, 3, size, size, c)
    # identity pairs are copies of the sender's map (flag 1); the twin
    # warps them with coefficients one rounding off the identity, which
    # at 160 x 160 moves its values by up to 2e-4
    for n in range(3):
        assert bool(coef[n, n, 7] == 1)
        want[n, n] = t(src)[0, int(rtype[n]), n]
    assert got.shape == (3, 3, size, size, c)
    assert torch.equal(got, want)
    if max_t > 50:  # spread poses: the kernels skip tiles here
        assert bool((~pfw.roi_tile_valid(coef, size)).any())
