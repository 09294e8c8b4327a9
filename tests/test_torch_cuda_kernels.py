"""The CUDA kernels against their plain PyTorch twins, on the card.

These need an NVIDIA GPU (Hopper, sm_90a) and nvcc: the kernels build
at first use.  They skip elsewhere.  The card's machine has no JAX, so
run them there without the suite's conftest:
``python -m pytest tests/test_torch_cuda_kernels.py -q -m gpu --noconftest``.
Float32 within 1e-4 absolute (same arithmetic, other order); bfloat16
within a few output ulps (bf16 ulp = 1/64 at |x| in [2, 4))."""
import numpy as np
import pytest
import torch

from chip_smoke import DEFORM_CASES, DEFORM_F32_TOL, deform_inputs
from hmvit_tpu_torch.ops import cuda, plain_ops
from hmvit_tpu_torch.ops.expand import (
    expand_rows_to_dense,
    expand_rows_to_dense_plain,
    expand_rows_to_dense_v2,
)
from hmvit_tpu_torch.ops.fused_warp import (
    fused_pair_warp,
    pair_warp_coefficients,
    pair_warp_launch,
    roi_tile_valid,
)
from hmvit_tpu_torch.ops.fused_warp_attention import (
    fused_warp_window_attention,
    warp_window_attention_launch,
)
from hmvit_tpu_torch.ops.sampling import (
    ms_deform_attn,
    ms_deform_attn_launch,
    ms_deform_attn_xla,
)
from hmvit_tpu_torch.ops.segscan import (
    fused_segmented_max_scan,
    scan_plan,
    segmented_max_scan_launch,
)
from hmvit_tpu_torch.ops.voxelize import scatter_max_to_bev
from hmvit_tpu_torch.ops.window_attention import (
    attention_body,
    fused_plain_window_attention,
    fused_stripe_window_attention,
    fused_window_attention,
    plain_window_attention_launch,
    stripe_window_attention_launch,
    typed_window_attention_launch,
)
from hmvit_tpu_torch.utils.precision import strict_fp32

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 0.0625}
# the stripe, plain and typed attention kernels in bfloat16 (tensor-core
# body, or the fp32 body on the shapes it keeps): one output ulp at |x| in
# [2, 4) and a half, as the on-card smoke run holds them; the fused warp +
# attention kernel attends over warped K / V that carry the warp's ulps
ATTN_BF16_TOL = 0.0313
FUSED_BF16_TOL = 0.125


def rigid_pairwise(rng, b, l, max_t, angles=None):
    """(B, L, L, 4, 4) transforms between random rigid poses."""
    ang = (rng.uniform(-np.pi, np.pi, (b, l)) if angles is None
           else np.broadcast_to(np.asarray(angles, np.float64), (b, l)))
    m = np.tile(np.eye(4), (b, l, 1, 1))
    m[:, :, 0, 0], m[:, :, 0, 1] = np.cos(ang), -np.sin(ang)
    m[:, :, 1, 0], m[:, :, 1, 1] = np.sin(ang), np.cos(ang)
    m[:, :, :2, 3] = rng.uniform(-max_t, max_t, (b, l, 2))
    return np.einsum("bixy,bjyz->bjixz", np.linalg.inv(m), m).astype(
        np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only on the card)")
    return torch.device("cuda", 0)


def _compare(fn, args, dtype):
    before = dict(cuda.launch_counts())
    with strict_fp32():
        got = fn(*args)
        with plain_ops():
            want = fn(*args)
    torch.cuda.synchronize()
    assert cuda.launch_counts() != before  # the kernel really ran
    assert got.dtype == want.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL[dtype], err
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("receivers", [None, 1])
@pytest.mark.parametrize("angles", [None, [0.0, np.pi / 2 + 1e-3, -1.2]])
def test_pair_warp_kernel(dev, dtype, receivers, angles):
    rng = np.random.default_rng(0)
    src = torch.randn(2, 2, 3, 40, 40, 24, device=dev).to(dtype)
    pair = torch.as_tensor(rigid_pairwise(rng, 2, 3, 12.0, angles),
                           device=dev)
    mode = torch.as_tensor([[0, 1, 1], [1, 0, 0]], device=dev)
    got = _compare(lambda *a: fused_pair_warp(*a, 0.4, 4, receivers),
                   (src, pair, mode), dtype)
    assert got.shape == (2, 3 if receivers is None else 1, 3, 40, 40, 24)
    # a frame's shared coefficients give the same launch
    coef = pair_warp_coefficients(pair, (40, 40), 0.4, 4)
    assert torch.equal(got, fused_pair_warp(src, pair, mode, 0.4, 4,
                                            receivers, coef))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("j,d", [(1, 32), (3, 16), (5, 32)])
def test_window_attention_kernels(dev, dtype, j, d):
    heads, win = 4, 8
    c, t = heads * d, win * win
    q = torch.randn(2, 24, 16, c, device=dev).to(dtype) * d ** -0.5
    kv = torch.randn(2, j, 24, 16, 2 * c, device=dev).to(dtype)
    bias = torch.randn(heads, t, t, device=dev).to(dtype)
    mask = (torch.rand(2, j, 24, 16, device=dev) > 0.3).to(dtype)
    mask[0, :, :win, :win] = 0  # fully masked window -> zeros
    out = _compare(
        lambda *a: fused_stripe_window_attention(*a, win, heads, d),
        (q, kv, bias, mask), dtype)
    assert torch.all(out[0, :win, :win] == 0)
    qw = q.reshape(2, 6, t, c)
    kvw = kv.reshape(2, j, 6, t, 2 * c)
    mw = mask.reshape(2, j, 6, t)
    _compare(lambda *a: fused_plain_window_attention(*a, heads, d),
             (qw, kvw, bias, mw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("win", [4, 8, 16])
def test_plain_window_attention_at_v2xvit_windows(dev, dtype, win):
    """The single-sender launches of V2X-ViT's pyramid: T = 16, 64 and
    256 tokens, 8 heads of 32 (T = 256 reads its bias from device memory:
    a head's 256 KB do not fit a block)."""
    heads, d, n, hw = 8, 32, 3, 32
    c, t = heads * d, win * win
    nwin = (hw // win) ** 2
    q = torch.randn(n, nwin, t, c, device=dev).to(dtype) * d ** -0.5
    kv = torch.randn(n, 1, nwin, t, 2 * c, device=dev).to(dtype)
    bias = torch.randn(heads, t, t, device=dev) * 0.5
    mask = torch.ones(n, 1, nwin, t, device=dev).to(dtype)
    bodies = cuda.attention_body_launches()["plain_window_attention"]
    _compare(lambda *a: fused_plain_window_attention(*a, heads, d),
             (q, kv, bias, mask), dtype)
    ran = cuda.attention_body_launches()["plain_window_attention"]
    body = attention_body(dtype, 1, t, d)
    assert body == ("mma" if dtype == torch.bfloat16 and t <= 128
                    else "simt")
    assert ran[body] == bodies[body] + 1


def _far_pair(rng, b, l, angles=None):
    """Rigid transforms with sender l-1 moved wholly out of every other
    agent's map (pair out of range), sender 0 co-located with itself
    (identity on the diagonal)."""
    pair = rigid_pairwise(rng, b, l, 10.0, angles)
    pair[:, l - 1, :l - 1, :2, 3] += 1e4
    pair[:, :l - 1, l - 1, :2, 3] -= 1e4
    return pair


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("receivers", [None, 1])
@pytest.mark.parametrize("size,angles", [(64, None), (96, [0.0, np.pi / 2 + 1e-3, -1.2])])
def test_resident_pair_warp_equals_tile_kernel(dev, dtype, receivers, size,
                                               angles):
    """The resident kernel against the twin, and bit for bit against the
    tile kernel (identity pairs on the diagonal, one sender wholly out
    of range, the conditioning swap near 90 degrees)."""
    rng = np.random.default_rng(3)
    src = torch.randn(2, 2, 3, size, size, 24, device=dev).to(dtype)
    pair = torch.as_tensor(_far_pair(rng, 2, 3, angles), device=dev)
    mode = torch.as_tensor([[0, 1, 1], [1, 0, 0]], device=dev)
    before = cuda.PAIR_WARP_RESIDENT.launches
    got = _compare(lambda *a: fused_pair_warp(*a, 0.4, 4, receivers,
                                              variant="resident"),
                   (src, pair, mode), dtype)
    assert cuda.PAIR_WARP_RESIDENT.launches == before + 1
    tile = fused_pair_warp(src, pair, mode, 0.4, 4, receivers,
                           variant="tile")
    assert torch.equal(got, tile)
    assert torch.all(got[:, 0, 2] == 0)  # the far sender: zeros


def test_resident_variant_falls_to_tile_on_small_maps(dev):
    src = torch.randn(1, 1, 2, 40, 40, 8, device=dev)
    pair = torch.as_tensor(rigid_pairwise(np.random.default_rng(0), 1, 2,
                                          5.0), device=dev)
    mode = torch.zeros(1, 2, dtype=torch.long, device=dev)
    before = dict(cuda.launch_counts())
    fused_pair_warp(src, pair, mode, 0.4, 4, variant="resident")
    after = cuda.launch_counts()
    assert after["pair_warp"] == before["pair_warp"] + 1
    assert after["pair_warp_resident"] == before["pair_warp_resident"]


def _poses(kind):
    """(pairwise (1, L, L, 4, 4) float32, (discrete_ratio,
    downsample_rate)) of a pose set: five agents within 12 m
    ("co-located"; agent 2 on agent 0's pose, so pairs (0, 2) and (2, 0)
    are identities) or within 120 m ("spread", the 204.8 m map at
    128^2), or the two agents of the 222nd draw of default_rng(0) (64 px
    maps at one metre a pixel), on which the Pallas kernels' tile skip
    is not conservative.  Sender 1 -> receiver 0 has non-finite
    coefficients (zeros)."""
    if kind == "draw222":
        rng = np.random.default_rng(0)
        for _ in range(222):
            pair = rigid_pairwise(rng, 1, 2, 90.0)
            rng.normal(size=(1, 1, 2, 64, 64, 8))
        geo = (1.0, 1.0)
    else:
        rng = np.random.default_rng(11)
        l, max_t = 5, 12.0 if kind == "co-located" else 120.0
        ang = rng.uniform(-np.pi, np.pi, (1, l))
        ang[0, 2] = ang[0, 0]
        m = np.tile(np.eye(4), (1, l, 1, 1))
        m[:, :, 0, 0], m[:, :, 0, 1] = np.cos(ang), -np.sin(ang)
        m[:, :, 1, 0], m[:, :, 1, 1] = np.sin(ang), np.cos(ang)
        m[:, :, :2, 3] = rng.uniform(-max_t, max_t, (1, l, 2))
        m[0, 2, :2, 3] = m[0, 0, :2, 3]
        pair = np.einsum("bixy,bjyz->bjixz", np.linalg.inv(m), m).astype(
            np.float32)
        geo = (0.4, 4)
    pair[0, 1, 0] = np.nan
    return pair, geo


@pytest.mark.parametrize("c", [8, 64, 512])
@pytest.mark.parametrize("size", [64, 96, 100, 128, 160])
@pytest.mark.parametrize("poses", ["co-located", "spread", "draw222"])
def test_new_pair_warp_kernels_equal_previous_body(dev, poses, size, c):
    """The redesigned tile kernel equals its previous body, and the
    resident kernel equals it, bit for bit, in both types, at every size
    the resident gate admits (bands of 8, 12, 16 and 20 rows; 16-byte
    slabs at 160) and at 100 x 100, where the resident variant runs the
    tile kernel, for receivers I in {1, 4, 5} (I <= L) and type variants
    TY in {1, 2}, with identity and non-finite pairs; the tile kernel
    also against the twin once a case.  Tiles out of view are zeros."""
    pair_np, geo = _poses(poses)
    pair = torch.as_tensor(pair_np, device=dev)
    l = pair.shape[1]
    g = torch.Generator(device=dev).manual_seed(size + c)
    coef = pair_warp_coefficients(pair, (size, size), *geo)
    seen = roi_tile_valid(coef, size)  # (1, L, L, XT, YT)
    for dtype in (torch.float32, torch.bfloat16):
        for i, ty in ((1, 2), (4, 1), (5, 2)):
            r = min(i, l)
            src = torch.randn(1, ty, l, size, size, c, generator=g,
                              device=dev).to(dtype)
            mode = torch.randint(0, ty, (1, l), generator=g, device=dev)
            args = (src, pair, mode, *geo, r)
            before = dict(cuda.launch_counts())
            new = fused_pair_warp(*args)
            launch, prev = pair_warp_launch(*args, previous=True)
            launch()
            res = fused_pair_warp(*args, variant="resident")
            torch.cuda.synchronize()
            after = cuda.launch_counts()
            resident = size in (64, 96, 128, 160)
            # at 100 x 100 the resident launch runs the tile kernel
            assert after["pair_warp"] == \
                before["pair_warp"] + (1 if resident else 2)
            assert after["pair_warp_resident"] == \
                before["pair_warp_resident"] + (1 if resident else 0)
            assert torch.equal(new, prev), (dtype, i, ty)
            assert torch.equal(res, new), (dtype, i, ty)
            assert torch.all(new[0, 0, 1] == 0)  # the non-finite pair
            n_t = -(-size // 32)
            tiles = torch.zeros(1, r, l, n_t * 32, n_t * 32, c, dtype=dtype,
                                device=dev)
            tiles[..., :size, :size, :] = new
            nz = (tiles != 0).reshape(1, r, l, n_t, 32, n_t, 32, c) \
                .any(-1).any(-1).any(-2).transpose(-1, -2)
            assert not bool((~seen[:, :r] & nz).any())
            if i == 4:
                with plain_ops():
                    want = fused_pair_warp(*args)
                want = torch.nan_to_num(want.float(), nan=0.0)
                # identity pairs (flag 1) are copies of the sender's map:
                # held to the map itself, since the twin warps them by
                # coefficients one rounding off the identity (1.6e-4 off
                # at 160 x 160)
                ident = (coef[:, :r, :, 7] == 1)[..., None, None, None]
                typed = src[0][mode[0, :r]][None]
                assert torch.equal(torch.where(ident, typed, new), new)
                want = torch.where(ident, typed.float(), want)
                err = float((new.float() - want).abs().max())
                assert err <= TOL[dtype], err


@pytest.mark.parametrize("size", [64, 96, 128])
@pytest.mark.parametrize("poses", ["co-located", "spread", "draw222"])
@pytest.mark.parametrize("variant", ["tile", "resident"])
def test_pair_warp_window_equals_the_whole_launch(dev, variant, poses, size):
    """The destination-row window of K1 (the SP island's) and of K5 (the
    resident kernel's): every window of whole 32-row tiles equals the
    whole launch's rows of the same kernel bit for bit, in both types, for
    every receiver and the ego alone, and the twin's window within the
    pair warp's tolerance (identity pairs: the sender's map); the
    launches count under the key "window"."""
    kernel = cuda.PAIR_WARP if variant == "tile" else cuda.PAIR_WARP_RESIDENT
    pair_np, geo = _poses(poses)
    pair = torch.as_tensor(pair_np, device=dev)
    l = pair.shape[1]
    g = torch.Generator(device=dev).manual_seed(size)
    coef = pair_warp_coefficients(pair, (size, size), *geo)
    n_t = size // 32
    windows = [(s, t) for t in range(1, n_t + 1) for s in range(n_t - t + 1)]
    for dtype in (torch.float32, torch.bfloat16):
        for r in (1, l):
            src = torch.randn(1, 2, l, size, size, 64, generator=g,
                              device=dev).to(dtype)
            mode = torch.randint(0, 2, (1, l), generator=g, device=dev)
            args = (src, pair, mode, *geo, r)
            whole = fused_pair_warp(*args, variant=variant)
            ident = (coef[:, :r, :, 7] == 1)[..., None, None, None]
            typed = src[0][mode[0, :r]][None]
            before = kernel.launches_by_key.get("window", 0)
            for start, tiles in windows:
                rows = slice(start * 32, (start + tiles) * 32)
                win = fused_pair_warp(*args, variant=variant,
                                      dest_row_start=start,
                                      dest_row_tiles=tiles)
                with plain_ops():
                    want = fused_pair_warp(*args, dest_row_start=start,
                                           dest_row_tiles=tiles)
                torch.cuda.synchronize()
                assert win.shape == (1, r, l, tiles * 32, size, 64)
                assert torch.equal(win, whole[:, :, :, rows]), \
                    (dtype, r, start, tiles)
                want = torch.where(ident, typed[..., rows, :, :].float(),
                                   torch.nan_to_num(want.float(), nan=0.0))
                err = float((win.float() - want).abs().max())
                assert err <= TOL[dtype], (dtype, r, start, tiles, err)
            assert kernel.launches_by_key["window"] == \
                before + len(windows)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("j,d,t", [(1, 32, 64), (3, 16, 16), (5, 32, 64)])
def test_typed_window_attention_kernel(dev, dtype, j, d, t):
    heads, n, nwin = 4, 2, 6
    c = heads * d
    g = torch.Generator(device=dev).manual_seed(j)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = (randn(n, nwin, t, c) * d ** -0.5).to(dtype)
    k, v = randn(n, j, nwin, t, c).to(dtype), randn(n, j, nwin, t, c).to(dtype)
    w_att = (randn(n, j, heads, d, d) * d ** -0.5).to(dtype)
    w_msg = (randn(n, j, heads, d, d) * d ** -0.5).to(dtype)
    bias = randn(heads, t, t).to(dtype)
    mask = (torch.rand(n, j, nwin, t, generator=g, device=dev) > 0.3).to(dtype)
    mask[0, :, 0] = 0  # fully masked window -> zeros
    out = _compare(lambda *a: fused_window_attention(*a, heads, d),
                   (q, k, v, w_att, w_msg, bias, mask), dtype)
    assert torch.all(out[0, 0] == 0)


def _body_case(dev, kind, dtype, n, j, nwin, t, heads, d, seed=0):
    """Operands of one plain or typed launch: the first sender fully
    masked in window 1, every key of map 0's window 0 masked."""
    c = heads * d
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    q = randn(n, nwin, t, c).to(dtype)
    bias = (randn(heads, t, t) * 0.5).to(dtype)
    mask = (torch.rand(n, j, nwin, t, generator=g, device=dev) > 0.3).to(dtype)
    mask[:, 0, 1] = 0
    mask[0, :, 0] = 0
    if kind == "plain":
        return (q, randn(n, j, nwin, t, 2 * c).to(dtype), bias, mask, heads,
                d), fused_plain_window_attention, "plain_window_attention"
    return (q, randn(n, j, nwin, t, c).to(dtype),
            randn(n, j, nwin, t, c).to(dtype),
            (randn(n, j, heads, d, d) * d ** -0.5).to(dtype),
            (randn(n, j, heads, d, d) * d ** -0.5).to(dtype), bias, mask,
            heads, d), fused_window_attention, "typed_window_attention"


@pytest.mark.parametrize("kind", ["plain", "typed"])
@pytest.mark.parametrize("dtype,j,t,heads,d,body", [
    (torch.bfloat16, 5, 64, 4, 32, "mma"),   # 320 keys, a masked sender
    (torch.bfloat16, 4, 64, 8, 32, "mma"),   # the serving head layout
    (torch.bfloat16, 3, 16, 2, 16, "mma"),   # the smallest tile
    (torch.bfloat16, 2, 64, 3, 32, "mma"),   # an odd head count: no pairs
    (torch.bfloat16, 2, 128, 2, 64, "mma"),  # the widest
    (torch.bfloat16, 2, 48, 2, 48, "mma"),   # 16-key units, 3 k-steps
    (torch.bfloat16, 3, 64, 4, 8, "simt"),   # d = 8: the fp32 body
    (torch.bfloat16, 3, 24, 2, 32, "simt"),  # T % 16 != 0: the fp32 body
    (torch.float32, 5, 64, 4, 32, "simt"),
])
def test_attention_bodies_by_type_and_shape(dev, kind, dtype, j, t, heads, d,
                                            body):
    """Each shape runs the body the rule names (counted inside the
    library), against the twin; fully masked rows give zeros; a fully
    masked first sender leaves no trace."""
    args, fn, name = _body_case(dev, kind, dtype, 2, j, 11, t, heads, d)
    assert attention_body(dtype, j, t, d) == body
    lib = cuda.load_library()
    assert lib.hm_attention_body_rule(cuda.DTYPE_CODES[dtype], j, t, d) == \
        cuda.ATTENTION_BODIES.index(body)
    before = cuda.attention_body_launches()[name]
    with strict_fp32():
        got = fn(*args)
        with plain_ops():
            want = fn(*args)
    torch.cuda.synchronize()
    after = cuda.attention_body_launches()[name]
    assert {b: after[b] - before[b] for b in after} == {
        b: int(b == body) for b in after}
    err = float((got.float() - want.float()).abs().max())
    assert err <= (1e-4 if dtype == torch.float32 else ATTN_BF16_TOL), err
    assert torch.all(got[0, 0] == 0) and torch.isfinite(got.float()).all()


@pytest.mark.parametrize("kind", ["plain", "typed"])
def test_previous_body_entry_agrees_with_the_new_one(dev, kind):
    """The timing-only entry runs the fp32 body on bfloat16 operands the
    chooser sends to the tensor cores; both stay within the tolerance of
    the twin, and the chooser's count does not move."""
    args, fn, name = _body_case(dev, kind, torch.bfloat16, 2, 4, 9, 64, 8, 32)
    prep = (plain_window_attention_launch if kind == "plain"
            else typed_window_attention_launch)
    with plain_ops():
        want = fn(*args).float()
    outs = {}
    for simt in (False, True):
        before = (cuda.KERNELS[name].launches,
                  cuda.attention_body_launches()[name])
        launch, out = prep(*args, simt=simt)
        launch()
        torch.cuda.synchronize()
        after = cuda.attention_body_launches()[name]
        body = "simt" if simt else "mma"
        assert after[body] == before[1][body] + 1
        assert cuda.KERNELS[name].launches == before[0] + int(not simt)
        outs[body] = out.float()
        assert float((outs[body] - want).abs().max()) <= ATTN_BF16_TOL
    assert float((outs["mma"] - outs["simt"]).abs().max()) <= ATTN_BF16_TOL


def _map_case(dev, kind, dtype, n, j, hw, win, heads, d, seed=0):
    """Operands of one stripe or fused warp + attention launch on
    unsplit (h, w) maps: the first sender fully masked in window 1 (the
    body's first unit leaves no trace), every key of map 0's window 0
    masked (zero rows).  The fused case has n = j receivers, an identity
    pair on the diagonal and, for j > 1, its last sender out of range
    (rows staged as zeros)."""
    h, w = hw
    c, t = heads * d, win * win
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    bias = (randn(heads, t, t) * 0.5).to(dtype)
    mask = (torch.rand(n, j, h, w, generator=g, device=dev) > 0.3).to(dtype)
    mask[:, 0, :win, win:2 * win] = 0
    mask[0, :, :win, :win] = 0
    if kind == "stripe":
        return (randn(n, h, w, c).to(dtype),
                randn(n, j, h, w, 2 * c).to(dtype), bias, mask, win, heads,
                d), fused_stripe_window_attention, "stripe_window_attention"
    assert h == w and n == j
    rng = np.random.default_rng(seed)
    pair = _far_pair(rng, 1, j) if j > 1 else rigid_pairwise(rng, 1, j, 1.0)
    mode = torch.as_tensor(rng.integers(0, 2, (1, j)), device=dev)
    return ((randn(n, h, w, c) * d ** -0.5).to(dtype),
            randn(1, 2, j, h, w, 2 * c).to(dtype),
            torch.as_tensor(pair, device=dev), mode, mask, bias, win, heads, d,
            0.4, 4, None), fused_warp_window_attention, \
        "warp_window_attention"


def _split_kernels(args):
    """The pair-warp kernel followed by the stripe attention kernel on a
    fused case's operands."""
    q, src, pair, mode, mask, bias, win, heads, d, ratio, rate, recv = args
    kv_pair = fused_pair_warp(src, pair, mode, ratio, rate, recv)
    return fused_stripe_window_attention(
        q, kv_pair.reshape(q.shape[0], *src.shape[2:]), bias, mask, win,
        heads, d)


@pytest.mark.parametrize("kind", ["stripe", "fused"])
@pytest.mark.parametrize("dtype,j,win,heads,d,body", [
    (torch.bfloat16, 5, 8, 4, 32, "mma"),   # 320 keys, a masked sender
    (torch.bfloat16, 4, 8, 8, 32, "mma"),   # the serving head layout
    (torch.bfloat16, 3, 4, 2, 16, "mma"),   # window 4: 16-key units
    (torch.bfloat16, 2, 8, 3, 32, "mma"),   # an odd head count: no pairs
    (torch.bfloat16, 2, 8, 2, 64, "mma"),   # the widest head
    (torch.bfloat16, 2, 4, 2, 48, "mma"),   # window 4, 3 k-steps
    (torch.bfloat16, 3, 8, 4, 8, "simt"),   # d = 8: the fp32 body
    (torch.bfloat16, 3, 6, 2, 32, "simt"),  # T = 36: the fp32 body
    (torch.float32, 5, 8, 4, 32, "simt"),
])
def test_map_attention_bodies_by_type_and_shape(dev, kind, dtype, j, win,
                                                heads, d, body):
    """The stripe and the fused kernel run the body the rule names
    (counted inside the library), against their twins; fully masked rows
    give zeros; the fused kernel equals pair warp -> stripe bit for bit on
    either body."""
    hw = (2 * win, 6 * win) if kind == "stripe" else (4 * win, 4 * win)
    args, fn, name = _map_case(dev, kind, dtype, j if kind == "fused" else 2,
                               j, hw, win, heads, d)
    assert attention_body(dtype, j, win * win, d) == body
    before = cuda.attention_body_launches()[name]
    with strict_fp32():
        got = fn(*args)
        with plain_ops():
            want = fn(*args)
    torch.cuda.synchronize()
    after = cuda.attention_body_launches()[name]
    assert {b: after[b] - before[b] for b in after} == {
        b: int(b == body) for b in after}
    err = float((got.float() - want.float()).abs().max())
    tol = ATTN_BF16_TOL if kind == "stripe" else FUSED_BF16_TOL
    assert err <= (1e-4 if dtype == torch.float32 else tol), err
    assert torch.all(got[0, :win, :win] == 0)
    assert torch.isfinite(got.float()).all()
    if kind == "fused":
        before = cuda.attention_body_launches()["stripe_window_attention"]
        assert torch.equal(got, _split_kernels(args))
        after = cuda.attention_body_launches()["stripe_window_attention"]
        assert after[body] == before[body] + 1  # the same body on both sides


@pytest.mark.parametrize("kind", ["stripe", "fused"])
def test_previous_body_entry_of_map_kernels(dev, kind):
    """As for the plain and typed kernels: the timing-only entry runs the
    fp32 body on bfloat16 operands, within the tolerance of the twin, and
    moves neither the wrapper's count nor the tensor-core count."""
    args, fn, name = _map_case(dev, kind, torch.bfloat16, 4, 4, (32, 32), 8,
                               8, 32)
    prep = (stripe_window_attention_launch if kind == "stripe"
            else warp_window_attention_launch)
    tol = ATTN_BF16_TOL if kind == "stripe" else FUSED_BF16_TOL
    with plain_ops():
        want = fn(*args).float()
    outs = {}
    for simt in (False, True):
        before = (cuda.KERNELS[name].launches,
                  cuda.attention_body_launches()[name])
        launch, out = prep(*args, simt=simt)
        launch()
        torch.cuda.synchronize()
        after = cuda.attention_body_launches()[name]
        body = "simt" if simt else "mma"
        assert after[body] == before[1][body] + 1
        assert cuda.KERNELS[name].launches == before[0] + int(not simt)
        outs[body] = out.float()
        assert float((outs[body] - want).abs().max()) <= tol
    assert float((outs["mma"] - outs["simt"]).abs().max()) <= tol


@pytest.mark.parametrize("kind,n,hw", [
    ("stripe", 2, (56, 344)),    # 301 windows: runs of 2
    ("stripe", 1, (56, 2344)),   # 2051 windows: runs of 8
    ("fused", 4, (136, 136)),    # 4 x 289 windows: runs of 4, the last short
])
def test_map_kernel_blocks_walk_runs_of_windows(dev, kind, n, hw):
    args, fn, _ = _map_case(dev, kind, torch.bfloat16, n,
                            n if kind == "fused" else 2, hw, 8, 8, 32)
    with strict_fp32():
        got = fn(*args)
        with plain_ops():
            want = fn(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= (ATTN_BF16_TOL if kind == "stripe" else FUSED_BF16_TOL), err
    assert torch.all(got[0, :8, :8] == 0)
    assert torch.isfinite(got.float()).all()
    if kind == "fused":
        assert torch.equal(got, _split_kernels(args))


@pytest.mark.parametrize("kind", ["plain", "typed"])
@pytest.mark.parametrize("n,nwin", [(2, 301), (1, 2051)])
def test_blocks_walk_runs_of_windows(dev, kind, n, nwin):
    """With windows enough a block walks 2 (301 windows) or 8 (2051) of
    them; the last run is short."""
    args, fn, _ = _body_case(dev, kind, torch.bfloat16, n, 2, nwin, 64, 8, 32)
    with strict_fp32():
        got = fn(*args)
        with plain_ops():
            want = fn(*args)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= ATTN_BF16_TOL, err
    assert torch.all(got[0, 0] == 0) and torch.isfinite(got.float()).all()


def test_body_rule_in_the_library_equals_its_mirror(dev):
    lib = cuda.load_library()
    for dtype, code in cuda.DTYPE_CODES.items():
        for j in (1, 2, 5, 6):
            for t in (4, 16, 24, 64, 128, 144, 320):
                for d in (4, 8, 16, 24, 32, 64, 80):
                    try:
                        want = cuda.ATTENTION_BODIES.index(
                            attention_body(dtype, j, t, d))
                    except ValueError:
                        want = -1
                    assert lib.hm_attention_body_rule(code, j, t, d) == want, \
                        (dtype, j, t, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("receivers", [None, 1])
@pytest.mark.parametrize("l,size", [(1, 32), (3, 64), (5, 32)])
def test_warp_window_attention_kernel(dev, dtype, receivers, l, size):
    """The fused kernel against its twin, and bit for bit against the
    pair-warp kernel followed by the stripe attention kernel."""
    heads, d, win = 2, 16, 8
    c, t = heads * d, win * win
    rng = np.random.default_rng(l)
    r = l if receivers is None else receivers
    g = torch.Generator(device=dev).manual_seed(l)
    src = torch.randn(2, 2, l, size, size, 2 * c, generator=g,
                      device=dev).to(dtype)
    q = (torch.randn(2 * r, size, size, c, generator=g, device=dev)
         * d ** -0.5).to(dtype)
    pair = _far_pair(rng, 2, l) if l > 1 else rigid_pairwise(rng, 2, l, 1.0)
    pair = torch.as_tensor(pair, device=dev)
    mode = torch.as_tensor(rng.integers(0, 2, (2, l)), device=dev)
    bias = torch.randn(heads, t, t, generator=g, device=dev).to(dtype)
    mask = (torch.rand(2 * r, l, size, size, generator=g, device=dev)
            > 0.2).to(dtype)
    mask[0, :, :win, :win] = 0  # fully masked window -> zeros
    before = cuda.launch_counts()["warp_window_attention"]
    got = _compare(
        lambda *a: fused_warp_window_attention(*a, win, heads, d, 0.4, 4,
                                               receivers),
        (q, src, pair, mode, mask, bias), dtype)
    assert cuda.launch_counts()["warp_window_attention"] == before + 1
    assert torch.all(got[0, :win, :win] == 0)
    kv_pair = fused_pair_warp(src, pair, mode, 0.4, 4, receivers)
    split = fused_stripe_window_attention(
        q, kv_pair.reshape(2 * r, l, size, size, 2 * c), bias, mask, win,
        heads, d)
    assert torch.equal(got, split)
    coef = pair_warp_coefficients(pair, (size, size), 0.4, 4)
    assert torch.equal(got, fused_warp_window_attention(
        q, src, pair, mode, mask, bias, win, heads, d, 0.4, 4, receivers,
        coef))


def test_kernel_backward_matches_plain_backward(dev):
    """The autograd wrappers: gradients through a kernel's forward equal
    the plain twin's gradients (both recompute through the twin)."""
    rng = np.random.default_rng(1)
    pair = torch.as_tensor(rigid_pairwise(rng, 1, 3, 12.0), device=dev)
    mode = torch.as_tensor([[0, 1, 1]], device=dev)
    heads, d, win = 2, 16, 8
    c = heads * d
    t = win * win
    bias = torch.randn(heads, t, t, device=dev)
    mask = (torch.rand(2, 3, 16, 16, device=dev) > 0.3).float()
    inputs = {
        "warp": (torch.randn(1, 2, 3, 16, 16, 8, device=dev),),
        "resident": (torch.randn(1, 2, 3, 64, 64, 8, device=dev),),
        "attn": (torch.randn(2, 16, 16, c, device=dev) * d ** -0.5,
                 torch.randn(2, 3, 16, 16, 2 * c, device=dev)),
        "typed": (torch.randn(2, 4, t, c, device=dev) * d ** -0.5,
                  torch.randn(2, 3, 4, t, c, device=dev),
                  torch.randn(2, 3, 4, t, c, device=dev),
                  torch.randn(2, 3, heads, d, d, device=dev) * 0.25,
                  torch.randn(2, 3, heads, d, d, device=dev) * 0.25,
                  bias.clone()),
        "fused": (torch.randn(3, 16, 16, c, device=dev) * d ** -0.5,
                  torch.randn(1, 2, 3, 16, 16, 2 * c, device=dev),
                  bias.clone()),
    }

    def run(kind, leaves):
        if kind == "warp":
            return fused_pair_warp(leaves[0], pair, mode, 0.4, 4)
        if kind == "resident":
            return fused_pair_warp(leaves[0], pair, mode, 0.4, 4,
                                   variant="resident")
        if kind == "typed":
            return fused_window_attention(
                *leaves, mask.reshape(2, 3, 4, t), heads, d)
        if kind == "fused":
            return fused_warp_window_attention(
                leaves[0], leaves[1], pair, mode,
                torch.cat([mask, mask[:1]]), leaves[2], win, heads, d, 0.4, 4)
        return fused_stripe_window_attention(leaves[0], leaves[1], bias,
                                             mask, win, heads, d)

    for kind, xs in inputs.items():
        grads = []
        for plain in (False, True):
            leaves = [x.clone().requires_grad_() for x in xs]
            with strict_fp32():
                if plain:
                    with plain_ops():
                        out = run(kind, leaves)
                else:
                    out = run(kind, leaves)
                out.square().sum().backward()
            grads.append([x.grad for x in leaves])
        for g_kernel, g_plain in zip(*grads):
            assert float((g_kernel - g_plain).abs().max()) <= 1e-4, kind


def _runs(rng, p, max_run, dropped=0.2):
    """Ids of consecutive runs of 1..max_run rows, some of them -1."""
    seg, cur = [], 0
    while len(seg) < p:
        run = int(rng.integers(1, max_run + 1))
        seg.extend([-1 if rng.random() < dropped else cur] * run)
        cur += int(rng.integers(1, 3))
    return np.asarray(seg[:p], np.int32)


# P, C, steps: P no multiple of any tile, C of 8 or not (one channel a
# thread then), runs up to 2**steps; the last is the long-run case (runs
# up to 4096 rows over up to 17 tiles: the second launch)
SCAN_SHAPES = [(1024, 8, 5), (60001, 64, 5), (777, 24, 3), (300, 64, 0),
               (777, 12, 5), (1021, 3, 4), (515, 1, 2), (65536, 64, 12)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,c,steps", SCAN_SHAPES)
def test_segmented_max_scan_kernel(dev, dtype, p, c, steps):
    """Bit for bit against the log-shift scan on every row whose id is
    >= 0; P is no multiple of any block, C of 8 or not (one channel per
    thread then), runs reach 2**steps, -1 runs lie between."""
    rng = np.random.default_rng(p)
    seg = torch.as_tensor(_runs(rng, p, 1 << steps), device=dev)
    vals = torch.randn(p, c, device=dev).to(dtype)
    before = cuda.SEGMENTED_MAX_SCAN.launches
    got = fused_segmented_max_scan(vals, seg, steps)
    assert cuda.SEGMENTED_MAX_SCAN.launches == before + 1
    with plain_ops():
        want = fused_segmented_max_scan(vals, seg, steps)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype
    valid = seg >= 0
    assert torch.equal(got[valid], want[valid])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p,c,steps", SCAN_SHAPES)
def test_segmented_max_scan_equals_previous_body(dev, dtype, p, c, steps):
    """The tiled kernel equals its previous body (a thread per row and 8
    channels, looking back a row at a time) bit for bit on every row
    whose id is >= 0; only the kernel's own counter moves for it."""
    rng = np.random.default_rng(p + 1)
    seg = torch.as_tensor(_runs(rng, p, 1 << steps), device=dev)
    vals = torch.randn(p, c, device=dev).to(dtype)
    outs = []
    for previous in (False, True):
        launch, out = segmented_max_scan_launch(vals, seg, steps, previous)
        before = cuda.launch_counts()
        launch()
        assert (cuda.launch_counts() != before) == (not previous)
        outs.append(out)
    torch.cuda.synchronize()
    valid = seg >= 0
    assert torch.equal(outs[0][valid], outs[1][valid])


def test_segmented_max_scan_plan_equals_its_mirror(dev):
    fn = cuda.load_library().hm_segmented_max_scan_plan
    for c in (1, 3, 8, 12, 24, 64, 256, 512, 520):
        for steps in (0, 5, 8, 9, 12, 30):
            rows, two_pass = scan_plan(c, steps)
            assert fn(c, steps) == (-rows if two_pass else rows), (c, steps)


def test_segmented_max_scan_giant_dropped_run_and_gradient(dev):
    """Only the -1 id may exceed 2**steps rows; its neighbours stay exact.
    The gradient is the plain version's."""
    p, c = 512, 8
    seg = torch.full((p,), -1, dtype=torch.int32, device=dev)
    seg[:16], seg[-8:] = 3, 7
    vals = torch.randn(p, c, device=dev)
    got = fused_segmented_max_scan(vals, seg, 5)
    assert torch.equal(got[15], vals[:16].max(dim=0).values)
    assert torch.equal(got[-1], vals[-8:].max(dim=0).values)
    last = torch.tensor([15, p - 1], device=dev)
    grads = []
    for plain in (False, True):
        v = vals.clone().requires_grad_()
        if plain:
            with plain_ops():
                out = fused_segmented_max_scan(v, seg, 5)
        else:
            out = fused_segmented_max_scan(v, seg, 5)
        out[last].square().sum().backward()
        grads.append(v.grad)
    assert torch.equal(*grads)
    # a view that is not contiguous and of C % 8 != 0 still launches
    before = cuda.SEGMENTED_MAX_SCAN.launches
    narrow = fused_segmented_max_scan(vals[:, :6], seg, 5)
    assert cuda.SEGMENTED_MAX_SCAN.launches == before + 1
    assert torch.equal(narrow[15], got[15, :6])


def _expand_ids(rng, block=4096):
    return np.unique(np.concatenate([
        rng.integers(0, block, 60),
        np.arange(block, 2 * block),                # a fully dense block
        np.arange(3 * block - 70, 3 * block + 70),  # across a boundary
    ])).astype(np.int32)                            # block 3's tail: empty


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 64, 3, 1])
def test_expand_kernels_equal_plain(dev, dtype, c):
    """Both kernels place rows exactly as the plain version does: empty
    and full blocks, a run across a block boundary, fill rows, and row
    widths that move as 16-, 8-, 4- and 2-byte words."""
    rng = np.random.default_rng(13)
    num_cells = 4 * 4096
    ids = _expand_ids(rng)
    fill = np.full(37, num_cells, np.int32)
    ids = torch.as_tensor(np.concatenate([ids, fill]), device=dev)
    comp = torch.randn(len(ids), c, device=dev).to(dtype)
    want = expand_rows_to_dense_plain(comp, ids, num_cells)
    for fn, kernel in ((expand_rows_to_dense, cuda.EXPAND_ROWS),
                       (expand_rows_to_dense_v2, cuda.EXPAND_ROWS_V2)):
        before = kernel.launches
        got = fn(comp, ids, num_cells)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got.dtype == dtype and torch.equal(got, want)
    real = ids[ids < num_cells].long()
    assert torch.equal(want[real], comp[:len(real)])
    assert int((want != 0).any(dim=1).sum()) <= len(real)


def test_expand_kernels_without_rows(dev):
    """M = 0 gives zeros from the kernels."""
    comp = torch.zeros(0, 64, device=dev)
    ids = torch.zeros(0, dtype=torch.int32, device=dev)
    for fn in (expand_rows_to_dense, expand_rows_to_dense_v2):
        before = dict(cuda.launch_counts())
        out = fn(comp, ids, 8192)
        assert cuda.launch_counts() != before
        assert out.shape == (8192, 64) and not out.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("num_cells", [5000, 704 * 200, 100, 4096 + 128 + 1])
def test_expand_kernels_take_any_grid(dev, dtype, num_cells):
    """Grids that are no multiple of 4096 or 128 cells launch the kernels
    like any other: the short last block and sub-block end at num_cells,
    the last cell is placed, fill rows and the memory behind the grid are
    left alone."""
    rng = np.random.default_rng(num_cells)
    ids = np.sort(rng.choice(num_cells, size=min(num_cells, 3000) // 2,
                             replace=False))
    ids[-1] = num_cells - 1
    ids = np.concatenate([ids, np.full(9, num_cells)]).astype(np.int32)
    ids = torch.as_tensor(ids, device=dev)
    comp = torch.randn(len(ids), 24, device=dev).to(dtype)
    want = expand_rows_to_dense_plain(comp, ids, num_cells)
    for fn, kernel in ((expand_rows_to_dense, cuda.EXPAND_ROWS),
                       (expand_rows_to_dense_v2, cuda.EXPAND_ROWS_V2)):
        before = kernel.launches
        got = fn(comp, ids, num_cells)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(want[-1], comp[len(ids) - 10])


def _slice_ids(rng, num_cells, repeats):
    """Sorted ids: a fully occupied 4096-cell block (16 slices of 256
    cells), a run across a slice boundary inside a sparse block, a few
    scattered cells, the last cell; with ``repeats`` each id 1-4 times
    (the first row must be placed); 13 fill rows behind them."""
    cells = np.unique(np.concatenate([
        np.arange(4096, 8192),                       # every cell occupied
        np.arange(3 * 256 - 40, 3 * 256 + 40),       # a slice boundary
        rng.integers(0, num_cells, 300), [num_cells - 1]]))
    ids = np.repeat(cells, rng.integers(1, 5, len(cells)) if repeats else 1)
    return np.concatenate([ids, np.full(13, num_cells)]).astype(np.int32)


@pytest.mark.parametrize("repeats", [False, True])
@pytest.mark.parametrize("num_cells", [4 * 4096, 704 * 200])
@pytest.mark.parametrize("dtype,c", [
    (torch.bfloat16, 64),   # 128-byte rows: 8 words of 16 B (serving)
    (torch.float32, 64),    # 256-byte rows: 16 words of 16 B
    (torch.bfloat16, 12),   # 24-byte rows: 3 words of 8 B
    (torch.float32, 12),    # 48-byte rows: 3 words of 16 B
])
def test_expand_kernels_slices_and_repeated_ids(dev, dtype, c, num_cells,
                                                repeats):
    """Both kernels against the plain version bit for bit on a fully
    occupied block, a run across a slice boundary and repeated ids (each
    id's first row placed, as the plain version's searchsorted places
    it), at the serving row widths and two others."""
    rng = np.random.default_rng(c + num_cells + repeats)
    ids_np = _slice_ids(rng, num_cells, repeats)
    ids = torch.as_tensor(ids_np, device=dev)
    comp = torch.randn(len(ids), c, device=dev).to(dtype)
    want = expand_rows_to_dense_plain(comp, ids, num_cells)
    real = ids_np[ids_np < num_cells]
    first = torch.as_tensor(np.searchsorted(ids_np, real), device=dev)
    assert torch.equal(want[torch.as_tensor(real, device=dev).long()],
                       comp[first])
    for fn, kernel in ((expand_rows_to_dense, cuda.EXPAND_ROWS),
                       (expand_rows_to_dense_v2, cuda.EXPAND_ROWS_V2)):
        before = kernel.launches
        got = fn(comp, ids, num_cells)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scatter_routes_give_one_grid(dev, dtype):
    """scatter_max_to_bev by every sorted route, kernels against the
    plain versions and against each other, bit for bit."""
    from hmvit_tpu_torch.ops.voxelize import pillarize

    g = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand(2, 3000, 4, generator=g, device=dev) * 12.6 - 6.3
    pts[..., 2] = pts[..., 2] * 0.1
    mask = (torch.rand(2, 3000, generator=g, device=dev) > 0.1).float()
    info = pillarize(pts, mask, (0.2, 0.2, 4.0),
                     (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0), (64, 64), 4)
    feats = torch.randn(6000, 64, generator=g, device=dev).to(dtype)
    outs = []
    for kwargs in ({}, {"use_scan_kernel": True}, {"use_expand_kernel": True},
                   {"use_expand_kernel": "v2", "use_scan_kernel": True}):
        for plain in (False, True):
            before = dict(cuda.launch_counts())
            if plain:
                with plain_ops():
                    out = scatter_max_to_bev(
                        feats, info["pillar_id"], info["keep"], (64, 64), 2,
                        max_run=4, **kwargs)
            else:
                out = scatter_max_to_bev(
                    feats, info["pillar_id"], info["keep"], (64, 64), 2,
                    max_run=4, **kwargs)
            launched = cuda.launch_counts() != before
            assert launched == (bool(kwargs) and not plain)
            outs.append(out)
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def test_cap_free_path_on_the_card(dev):
    """``enforce_cap=False`` sums with ``index_add_``, whose float atomics
    add in no fixed order on the card: the statistics and the PFN's grid
    are held to the CPU's at 1e-5, not to equality; the bfloat16 grid is
    finite and fills no other cells."""
    from hmvit_tpu_torch.models.pillar_encoder import PillarFeatureNet
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops.voxelize import pillarize

    g = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 3000, 4, generator=g) * 12.6 - 6.3
    pts[..., 2] = pts[..., 2] * 0.1
    mask = (torch.rand(2, 3000, generator=g) > 0.1).float()
    args = ((0.2, 0.2, 4.0), (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0), (64, 64))
    want = pillarize(pts, mask, *args, enforce_cap=False)
    got = pillarize(pts.to(dev), mask.to(dev), *args, enforce_cap=False)
    for key in ("pillar_id", "keep"):
        assert torch.equal(got[key].cpu(), want[key])
    for key in ("mean_xyz", "center_offset", "count_per_point"):
        assert float((got[key].cpu() - want[key]).abs().max()) <= 1e-5, key
    net = init_parameters(PillarFeatureNet([16, 32], *args,
                                           enforce_cap=False), seed=0).eval()
    with torch.no_grad(), strict_fp32():
        grid_cpu = net(pts, mask)
        grid_dev = net.to(dev)(pts.to(dev), mask.to(dev))
        net16 = init_parameters(PillarFeatureNet(
            [16, 32], *args, enforce_cap=False, compute_dtype="bfloat16"),
            seed=0).to(dev, torch.bfloat16).eval()
        grid_bf16 = net16(pts.to(dev), mask.to(dev))
    assert float((grid_dev.cpu() - grid_cpu).abs().max()) <= 1e-5
    assert grid_bf16.dtype == torch.bfloat16
    assert torch.isfinite(grid_bf16.float()).all()
    filled = (grid_cpu != 0).any(dim=-1)
    assert not ((grid_bf16 != 0).any(dim=-1).cpu() & ~filled).any()


def _check_deform(value, shapes, loc, w):
    """Kernel against the twin in the operands' type, and in bfloat16 also
    against the float32 twin on the same operands (the kernel keeps
    float32 inside): within half an output ulp."""
    dtype = value.dtype
    before = cuda.MS_DEFORM_ATTN.launches
    with strict_fp32():
        got = ms_deform_attn(value, shapes, loc, w)
        with plain_ops():
            want = ms_deform_attn(value, shapes, loc, w)
            want32 = ms_deform_attn_xla(value.float(), shapes, loc,
                                        w.float())
    torch.cuda.synchronize()
    assert cuda.MS_DEFORM_ATTN.launches == before + 1
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        assert err <= DEFORM_F32_TOL, err
    else:
        assert err <= TOL[dtype], err
        excess = ((got.float() - want32).abs()
                  - (want32.abs() * 2.0 ** -8 + 1e-5))
        assert float(excess.max()) <= 0.0, float(excess.max())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(DEFORM_CASES))
def test_ms_deform_attn_kernel_at_the_cell_shapes(dev, dtype, case):
    value_shape, loc_shape, shapes = DEFORM_CASES[case]
    value, loc, w = deform_inputs(dev, value_shape, loc_shape, dtype)
    _check_deform(value, shapes, loc, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,d,points", [(3, 48, 20), (8, 32, 4),
                                            (1, 7, 1)])
def test_ms_deform_attn_kernel_on_two_levels_and_edges(dev, dtype, heads, d,
                                                       points):
    """mmcv's multi-level contract (2 levels of other sizes), rows that do
    not fill a block, a channel chunk left partly idle and more points
    than one staging round; every tap outside both maps reads zero."""
    shapes = [(6, 9), (3, 5)]
    k = sum(h * w for h, w in shapes)
    value, loc, w = deform_inputs(dev, (2, k, heads, d),
                                  (2, 37, heads, 2, points, 2), dtype,
                                  seed=1, lo=-0.3, hi=1.3)
    got = _check_deform(value, shapes, loc, w)
    # a query whose every point lies outside both maps
    loc[0, 0] = torch.tensor([1.5, -0.5], device=dev)
    got = _check_deform(value, shapes, loc, w)
    assert not got[0, 0].any()


def test_ms_deform_attn_gradients_equal_the_twins(dev):
    value, loc, w = deform_inputs(dev, (2, 56, 4, 32), (2, 64, 4, 2, 3, 2),
                                  torch.float32, seed=2)
    shapes = [(7, 6), (2, 7)]
    grads = []
    for plain in (False, True):
        leaves = [x.clone().requires_grad_() for x in (value, loc, w)]
        with strict_fp32():
            if plain:
                with plain_ops():
                    out = ms_deform_attn(leaves[0], shapes, *leaves[1:])
            else:
                out = ms_deform_attn(leaves[0], shapes, *leaves[1:])
            out.square().sum().backward()
        grads.append([x.grad for x in leaves])
    for g_kernel, g_plain in zip(*grads):
        assert float((g_kernel - g_plain).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ms_deform_attn_captured_graph_equals_eager(dev, dtype):
    value_shape, loc_shape, shapes = DEFORM_CASES["sca"]
    value, loc, w = deform_inputs(dev, value_shape, loc_shape, dtype)
    eager = ms_deform_attn(value, shapes, loc, w)
    launch, out = ms_deform_attn_launch(value, shapes, loc, w)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        launch()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ms_deform_attn(value, shapes, loc, w)
    for _ in range(3):
        captured.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
    assert torch.equal(out, eager)


def test_ms_deform_attn_launches_per_bevformer_ref_frame(dev):
    """One eager frame of HMViT with ``encoder: bevformer_ref`` (3 layers)
    and a camera agent: one launch per temporal self-attention and one
    per spatial cross-attention, 6."""
    import copy
    import os

    import chip_smoke
    from hmvit_tpu_torch.config import load_config
    from hmvit_tpu_torch.data.synthetic import make_hetero_batch
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.serving import batch_to_device, serving_hints

    params = load_config(os.path.join(chip_smoke.HYPES,
                                      "smoke_hetero_tiny.yaml"))
    cfg = copy.deepcopy(params["model"]["args"])
    camera = dict(chip_smoke.ZOO_CAMERAS["bevformer_ref"][0], num_layers=3)
    cfg["camera"] = dict(cfg["camera"], **camera)
    batch, _ = make_hetero_batch(
        seed=3, max_cav=2, num_agents=2, max_points=512, image_size=64,
        num_cams=4, camera_ratio=0.5, ego_mode="lidar",
        lidar_range=params["preprocess"]["cav_lidar_range"])
    batch["mode"][:, :2] = (1, 0)  # a lidar ego and a camera agent
    tb = batch_to_device(batch, dev, bf16=False)
    hints = serving_hints(batch["mode"][0], 2)
    model = init_parameters(HMViT(cfg), seed=0).to(dev)
    before = cuda.MS_DEFORM_ATTN.launches
    with torch.no_grad():
        model(tb, **hints)
    torch.cuda.synchronize()
    assert cuda.MS_DEFORM_ATTN.launches - before == 6
