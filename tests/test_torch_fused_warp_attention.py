"""Port parity: the fused warp + attention wrapper's plain twin vs the
JAX package, at the 64^2 shapes of tests/test_fused_warp_attention.py.

The twin (pair-warp twin, window split, plain attention twin, merge) is
held against the Pallas fused kernel in interpret mode and against the
JAX oracle ``warp_window_attention_xla`` within 1e-4 absolute: float32
attention over unit-normal maps whose warp coordinates the two
frameworks round ~1e-5 px apart (the bar of the pair-warp cases in
test_torch_warp.py; the scores here are kept at unit variance so the
softmax does not amplify it).  The wrapper's backward is held against
jax.grad of the oracle for q, src_typed and bias."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops import fused_warp_attention as jfwa
from hmvit_tpu_torch.ops import fused_warp_attention as pfwa
from hmvit_tpu_torch.ops.fused_warp import pair_warp_coefficients
from torch_parity import close, rigid_pairwise, t

B, L, H = 1, 3, 64
HEADS, D, WIN = 2, 16, 8
C, T = HEADS * D, WIN * WIN
ATOL = 1e-4
ARGS = (WIN, HEADS, D, 1.0, 1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, r=L, max_t=6.0, hw=H):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, 2, L, hw, hw, 2 * C)).astype(np.float32)
    pair = rigid_pairwise(rng, B, L, max_t=max_t)
    mode = rng.integers(0, 2, (B, L)).astype(np.int32)
    q = (rng.standard_normal((B * r, hw, hw, C)) * D ** -0.5).astype(
        np.float32)
    mask = (rng.uniform(size=(B * r, L, hw, hw)) > 0.2).astype(np.float32)
    mask[0, :, :WIN, :WIN] = 0.0  # receiver 0, window 0: every key masked
    bias = (rng.standard_normal((HEADS, T, T)) * 0.1).astype(np.float32)
    return q, src, pair, mode, mask, bias


@pytest.mark.parametrize("seed,max_t", [(0, 5.0), (1, 20.0)])
def test_twin_vs_pallas_fused_and_oracle(seed, max_t):
    args = _inputs(seed, max_t=max_t)
    jargs = tuple(map(jnp.asarray, args))
    got = pfwa.fused_warp_window_attention(*map(t, args), *ARGS).numpy()
    pallas = np.asarray(jfwa.warp_window_attention(*jargs, *ARGS,
                                                   interpret=True))
    oracle = np.asarray(jfwa.warp_window_attention_xla(*jargs, *ARGS))
    assert got.shape == pallas.shape == (B * L, H, H, C)
    close(got, oracle, ATOL)
    close(got, pallas, ATOL)
    assert np.all(got[0, :WIN, :WIN] == 0.0)


def test_receiver_subset_vs_pallas_fused():
    """num_receivers=1, the ego-only last phase: the first receiver of
    the full launch."""
    q, src, pair, mode, mask, bias = _inputs(4)
    full = pfwa.fused_warp_window_attention(
        *map(t, (q, src, pair, mode, mask, bias)), *ARGS).numpy()
    ego = pfwa.fused_warp_window_attention(
        *map(t, (q[:1], src, pair, mode, mask[:1], bias)), *ARGS,
        num_receivers=1).numpy()
    pallas = np.asarray(jfwa.warp_window_attention(
        *map(jnp.asarray, (q[:1], src, pair, mode, mask[:1], bias)), *ARGS,
        num_receivers=1, interpret=True))
    assert ego.shape == pallas.shape == (1, H, H, C)
    close(ego, pallas, ATOL)
    close(ego[0], full[0], 1e-6)


def test_shared_coefficients_leave_the_twin_alone():
    """The frame's coefficient table is the kernel path's; the twin
    derives its geometry from pairwise and ignores it."""
    args = tuple(map(t, _inputs(6, hw=16)))
    coef = pair_warp_coefficients(args[2], (16, 16), 1.0, 1.0)
    assert torch.equal(
        pfwa.fused_warp_window_attention(*args, *ARGS, coef=coef),
        pfwa.fused_warp_window_attention(*args, *ARGS))


def test_backward_matches_oracle_grads():
    """Gradients for q, src_typed and bias against jax.grad of the JAX
    oracle; geometry, mode and mask take none."""
    q, src, pair, mode, mask, bias = _inputs(5, max_t=3.0, hw=32)
    leaves = {k: t(v).requires_grad_()
              for k, v in (("q", q), ("src", src), ("bias", bias))}
    tp, tm = t(pair).requires_grad_(), t(mask).requires_grad_()
    pfwa.fused_warp_window_attention(
        leaves["q"], leaves["src"], tp, t(mode), tm, leaves["bias"],
        *ARGS).square().sum().backward()

    def loss(q_, s_, b_):
        out = jfwa.warp_window_attention_xla(
            q_, s_, jnp.asarray(pair), jnp.asarray(mode), jnp.asarray(mask),
            b_, *ARGS)
        return jnp.sum(out * out)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(src), jnp.asarray(bias))
    for leaf, g in zip(leaves.values(), want):
        close(leaf.grad, g, 2e-4, rtol=2e-4)
        assert float(leaf.grad.abs().sum()) > 0


@pytest.mark.parametrize("bad", ["src_channels", "q_shape", "mask_shape",
                                 "bias_shape", "pairwise_shape", "mode_shape",
                                 "receivers", "coef_shape", "not_square",
                                 "window", "dtype"])
def test_launch_rejects_malformed_inputs(bad):
    """Every shape and type the fused kernel indexes with is checked
    before a pointer reaches the device (no kernel is built here)."""
    q, src, pair, mode, mask, bias = map(t, _inputs(0, hw=16))
    kwargs, error, win = {}, ValueError, WIN
    if bad == "src_channels":
        src = src[..., :-8]
    elif bad == "q_shape":
        q = q[:2]
    elif bad == "mask_shape":
        mask = mask[:, :2]
    elif bad == "bias_shape":
        bias = bias[:, :-1]
    elif bad == "pairwise_shape":
        pair = pair[:, :2]
    elif bad == "mode_shape":
        mode = mode[:, :2]
    elif bad == "receivers":
        kwargs["num_receivers"] = L + 1
    elif bad == "coef_shape":
        kwargs["coef"] = torch.zeros(B, L, L, 7)
    elif bad == "not_square":
        q, src, mask = q[:, :8], src[:, :, :, :8], mask[:, :, :8]
    elif bad == "window":
        win = 6
    elif bad == "dtype":
        src, error = src.to(torch.bfloat16), TypeError
    with pytest.raises(error):
        pfwa.warp_window_attention_launch(q, src, pair, mode, mask, bias,
                                          win, HEADS, D, 1.0, 1.0, **kwargs)
