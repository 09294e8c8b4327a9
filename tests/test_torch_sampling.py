"""Port parity of the deformable-attention sampling ops
(``hmvit_tpu_torch/ops/sampling.py``): ``bilinear_sample`` and
``ms_deform_attn`` against the JAX package's on the CPU, at the shapes
of ``tests/test_deformable_oracle.py``, taps inside, straddling and
outside the map (which read 0); float32 within 1e-5.  The wrapper of
the CUDA kernel (``csrc/ms_deform_attn.cu``) as far as the CPU reaches
it: the plain twin on CPU tensors and under ``plain_ops()``, the
launch's argument checks, the autograd Function's wiring."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops.sampling import bilinear_sample as jbilinear
from hmvit_tpu.ops.sampling import ms_deform_attn as jms_deform_attn
from hmvit_tpu_torch.ops import cuda, plain_ops, sampling
from hmvit_tpu_torch.ops.sampling import (
    bilinear_sample,
    ms_deform_attn,
    ms_deform_attn_launch,
    ms_deform_attn_xla,
)
from torch_parity import close, t


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
def test_bilinear_sample_matches_jax(seed):
    rng = np.random.default_rng(seed)
    b, h, w, c, q = 3, 9, 13, 5, 64
    feats = rng.standard_normal((b, h, w, c)).astype(np.float32)
    pix = rng.uniform(-3.0, [w + 2.0, h + 2.0], (b, q, 2)).astype(
        np.float32)
    # exact integers and the last pixel's edge: floor and the bounds
    pix[:, :4] = [[0.0, 0.0], [w - 1.0, h - 1.0], [-1.0, 2.0],
                  [w - 0.5, h - 0.5]]
    got = bilinear_sample(t(feats), t(pix))
    want = jbilinear(jnp.asarray(feats), jnp.asarray(pix))
    assert tuple(got.shape) == (b, q, c)
    close(got, want, 1e-5)
    outside = (pix[..., 0] <= -1) | (pix[..., 0] >= w) | \
        (pix[..., 1] <= -1) | (pix[..., 1] >= h)
    assert outside.any() and not got.numpy()[outside].any()


@pytest.mark.parametrize("seed", [0, 3])
def test_ms_deform_attn_matches_jax(seed):
    rng = np.random.default_rng(seed)
    bs, heads, d, q, p = 2, 4, 8, 10, 3
    shapes = [(6, 9), (3, 5)]
    k = sum(h * w for h, w in shapes)
    value = rng.standard_normal((bs, k, heads, d)).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (bs, q, heads, len(shapes), p, 2)).astype(
        np.float32)
    w = rng.uniform(0, 1, (bs, q, heads, len(shapes), p)).astype(np.float32)
    w /= w.reshape(bs, q, heads, -1).sum(-1)[..., None, None]
    got = ms_deform_attn(t(value), shapes, t(locs), t(w))
    want = jms_deform_attn(jnp.asarray(value), shapes, jnp.asarray(locs),
                           jnp.asarray(w))
    assert tuple(got.shape) == (bs, q, heads * d)
    close(got, want, 1e-5)


def test_bilinear_sample_gradient_reaches_features_and_coords():
    """Training through the deformable lift: the gather's gradient flows
    to the features and the lerp's to the coordinates."""
    rng = np.random.default_rng(2)
    feats = t(rng.standard_normal((1, 5, 6, 3)).astype(np.float32))
    pix = t(rng.uniform(0.2, 3.8, (1, 7, 2)).astype(np.float32))
    feats.requires_grad_(True)
    pix.requires_grad_(True)
    bilinear_sample(feats, pix).square().sum().backward()
    assert feats.grad.abs().sum() > 0 and pix.grad.abs().sum() > 0


def _deform_case(seed=4, dtype=torch.float32):
    """mmcv's two-level contract at a tiny size: value, levels, locations
    (some outside the maps), normalised weights."""
    rng = np.random.default_rng(seed)
    bs, heads, d, q, p = 2, 3, 8, 9, 4
    shapes = [(5, 7), (2, 3)]
    k = sum(h * w for h, w in shapes)
    value = t(rng.standard_normal((bs, k, heads, d)).astype(np.float32))
    locs = t(rng.uniform(-0.2, 1.2, (bs, q, heads, 2, p, 2)).astype(
        np.float32))
    w = torch.softmax(t(rng.standard_normal((bs, q, heads, 2 * p)).astype(
        np.float32)), -1).reshape(bs, q, heads, 2, p)
    return value.to(dtype), shapes, locs, w.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ms_deform_attn_is_its_twin_on_the_cpu(dtype):
    """CPU tensors, and CPU tensors under ``plain_ops()``: the wrapper
    runs the plain twin, bit for bit, and launches nothing."""
    value, shapes, locs, w = _deform_case(dtype=dtype)
    before = cuda.launch_counts()
    want = ms_deform_attn_xla(value, shapes, locs, w)
    assert torch.equal(ms_deform_attn(value, shapes, locs, w), want)
    with plain_ops():
        assert torch.equal(ms_deform_attn(value, shapes, locs, w), want)
    # the twin also takes mmcv's tensor of levels
    assert torch.equal(ms_deform_attn(value, torch.tensor(shapes), locs, w),
                       want)
    assert cuda.launch_counts() == before


def _bad_args(case):
    """One argument set the kernel does not take (CPU tensors: every check
    but the device's comes first)."""
    value, shapes, locs, w = _deform_case()
    if case == "value float64":
        value = value.double()
    elif case == "weights in another type":
        w = w.to(torch.bfloat16)
    elif case == "bfloat16 locations":
        locs = locs.to(torch.bfloat16)
    elif case == "levels as a tensor":
        shapes = torch.tensor(shapes)
    elif case == "five levels":
        shapes = shapes + [(1, 1)] * 3
    elif case == "an empty level":
        shapes = [(5, 7), (0, 3)]
    elif case == "levels miss K":
        shapes = [(5, 7), (2, 2)]
    elif case == "value 3-D":
        value = value.flatten(2)
    elif case == "weights of another shape":
        w = w[:, :, :, :, :3]
    elif case == "locations of another shape":
        locs = locs[:, :, :2]
    elif case == "strided value":
        value = value.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "strided locations":
        locs = locs.transpose(1, 2).contiguous().transpose(1, 2)
    return value, shapes, locs, w


BAD_ARGS = {"value float64": TypeError, "weights in another type": TypeError,
            "bfloat16 locations": TypeError, "levels as a tensor": TypeError,
            "five levels": ValueError, "an empty level": ValueError,
            "levels miss K": ValueError, "value 3-D": ValueError,
            "weights of another shape": ValueError,
            "locations of another shape": ValueError,
            "strided value": ValueError, "strided locations": ValueError,
            "host tensors": ValueError}


@pytest.mark.parametrize("case", sorted(BAD_ARGS))
def test_ms_deform_attn_launch_refuses_what_the_kernel_does_not_take(case):
    before = cuda.launch_counts()
    with pytest.raises(BAD_ARGS[case], match="ms_deform_attn"):
        ms_deform_attn_launch(*_bad_args(case))
    assert cuda.launch_counts() == before


def test_ms_deform_attn_kernel_forward_backward_is_the_twins(monkeypatch):
    """The autograd Function around the kernel, its launch replaced by the
    twin's output (no card here): the forward's value and the gradients
    of value, locations and weights are the twin's, bit for bit, and
    locations that need none get none."""
    value, shapes, locs, w = _deform_case(seed=5)

    def fake_launch(v, s, l, a):
        return (lambda: None), ms_deform_attn_xla(v, s, l, a)

    monkeypatch.setattr(sampling, "use_kernel", lambda x: True)
    monkeypatch.setattr(sampling, "ms_deform_attn_launch", fake_launch)
    g = torch.randn(2, 9, 24, generator=torch.Generator().manual_seed(0))
    for need_locs in (True, False):
        got, want = [], []
        for fn, into in ((sampling.ms_deform_attn, got),
                         (ms_deform_attn_xla, want)):
            leaves = [value.clone().requires_grad_(),
                      locs.clone().requires_grad_(need_locs),
                      w.clone().requires_grad_()]
            out = fn(leaves[0], shapes, leaves[1], leaves[2])
            out.backward(g)
            into.append(out.detach())
            into.extend(x.grad for x in leaves)
        assert got[2] is None if not need_locs else got[2] is not None
        for a, b in zip(got, want):
            assert (a is None and b is None) or torch.equal(a, b)
