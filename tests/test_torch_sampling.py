"""Port parity of the deformable-attention sampling ops
(``hmvit_tpu_torch/ops/sampling.py``): ``bilinear_sample`` and
``ms_deform_attn`` against the JAX package's on the CPU, at the shapes
of ``tests/test_deformable_oracle.py``, taps inside, straddling and
outside the map (which read 0); float32 within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops.sampling import bilinear_sample as jbilinear
from hmvit_tpu.ops.sampling import ms_deform_attn as jms_deform_attn
from hmvit_tpu_torch.ops.sampling import bilinear_sample, ms_deform_attn
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
