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

from hmvit_tpu_torch.ops import cuda, plain_ops
from hmvit_tpu_torch.ops.fused_warp import (
    fused_pair_warp,
    pair_warp_coefficients,
)
from hmvit_tpu_torch.ops.fused_warp_attention import (
    fused_warp_window_attention,
)
from hmvit_tpu_torch.ops.window_attention import (
    fused_plain_window_attention,
    fused_stripe_window_attention,
    fused_window_attention,
)
from hmvit_tpu_torch.utils.precision import strict_fp32

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 0.0625}


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
