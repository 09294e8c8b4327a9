"""Port parity: the window-attention kernels' plain twins vs the Pallas
kernels in interpret mode (stripe_window_attention, plain_window_
attention, and the typed hetero_window_attention with its XLA oracle),
with masked senders, fully masked query rows (which must emit zeros)
and J in {1, 3}.  Float32, 2e-5 absolute (1e-5 for the typed kernel):
softmax-attention of unit-normal inputs in another summation order.
Gradients of the typed wrapper are held to jax.grad of the oracle
(1e-4).  The camera branch's WindowSelfAttention (the plain kernel with
J = 1) is held against its flax module too."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models.fusion.v2xvit import WindowSelfAttention as JWSA
from hmvit_tpu.ops import window_attention as jwa
from hmvit_tpu_torch.models.fusion.v2xvit import WindowSelfAttention
from hmvit_tpu_torch.ops import plain_ops, use_kernel
from hmvit_tpu_torch.ops import window_attention as pwa
from torch_parity import bridged, close, flax_variables, t

ATOL = 2e-5
HEADS, D, WIN = 2, 8, 4
C = HEADS * D


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(seed, n, j, lead):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, *lead, C)).astype(np.float32) * D ** -0.5
    kv = rng.standard_normal((n, j, *lead, 2 * C)).astype(np.float32)
    bias = rng.standard_normal((HEADS, WIN * WIN, WIN * WIN)).astype(
        np.float32)
    mask = (rng.uniform(size=(n, j, *lead)) > 0.3).astype(np.float32)
    # receiver 0 sees no sender in its first window: zero rows
    mask[0, :, :WIN, :WIN] = 0.0
    return q, kv, bias, mask


@pytest.mark.parametrize("j", [1, 3])
def test_stripe_twin_vs_pallas(j):
    q, kv, bias, mask = _inputs(j, 2, j, (8, 16))
    got = pwa.fused_stripe_window_attention(t(q), t(kv), t(bias), t(mask),
                                            WIN, HEADS, D).numpy()
    want = np.asarray(jwa.stripe_window_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bias), jnp.asarray(mask),
        win=WIN, heads=HEADS, dim_head=D, interpret=True))
    close(got, want, ATOL)
    assert np.all(got[0, :WIN, :WIN] == 0.0)


@pytest.mark.parametrize("j", [1, 3])
def test_plain_twin_vs_pallas(j):
    q, kv, bias, mask = _inputs(10 + j, 2, j, (4, WIN * WIN))
    mask[0, :, 0] = 0.0  # window 0 of receiver 0 fully masked
    got = pwa.fused_plain_window_attention(t(q), t(kv), t(bias), t(mask),
                                           HEADS, D).numpy()
    want = np.asarray(jwa.plain_window_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(bias), jnp.asarray(mask),
        heads=HEADS, dim_head=D, interpret=True))
    close(got, want, ATOL)
    assert np.all(got[0, 0] == 0.0)


def test_cpu_tensors_take_the_twin():
    x = torch.zeros(2)
    assert not use_kernel(x)
    with plain_ops():
        assert not use_kernel(x)


def test_attention_grads_recompute_through_twin():
    q, kv, bias, mask = _inputs(5, 1, 2, (8, 8))
    tq, tkv = t(q).requires_grad_(), t(kv).requires_grad_()
    pwa.fused_stripe_window_attention(tq, tkv, t(bias), t(mask), WIN, HEADS,
                                      D).sum().backward()
    assert torch.isfinite(tq.grad).all() and tkv.grad.abs().sum() > 0


def test_window_self_attention_matches_flax():
    x = np.random.default_rng(7).standard_normal((2, 1, 8, 8, C)).astype(
        np.float32)
    jm = JWSA(C, WIN, HEADS)
    v = flax_variables(jm, x)
    pm = bridged(WindowSelfAttention(C, WIN, HEADS), v)
    close(pm(t(x)), jm.apply(v, x), ATOL)


@pytest.mark.parametrize("bad", ["kv_channels", "mask_shape", "bias_shape",
                                 "heads"])
@pytest.mark.parametrize("style", ["stripe", "plain"])
def test_attention_launch_rejects_malformed_inputs(bad, style):
    """The kernel wrappers check every shape the kernel indexes with
    before a pointer reaches the device (no kernel is built here)."""
    lead = (8, 16) if style == "stripe" else (4, WIN * WIN)
    q, kv, bias, mask = _inputs(0, 2, 3, lead)
    heads = HEADS
    if bad == "kv_channels":
        kv = kv[..., :-8]
    elif bad == "mask_shape":
        mask = mask[:, :2]
    elif bad == "bias_shape":
        bias = bias[:, :-1]
    else:
        heads = HEADS + 1
    args = (t(q), t(kv), t(bias), t(mask))
    with pytest.raises(ValueError):
        if style == "stripe":
            pwa.stripe_window_attention_launch(*args, WIN, heads, D)
        else:
            pwa.plain_window_attention_launch(*args, heads, D)


TYPED_ATOL = 1e-5


def _typed_inputs(seed, n=2, j=3, nwin=4):
    """Typed attention inputs with unit-variance scores: q pre-scaled,
    relation matrices at d ** -0.5."""
    rng = np.random.default_rng(seed)
    t_tok = WIN * WIN

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    q = normal(n, nwin, t_tok, C, scale=D ** -0.5)
    k, v = normal(n, j, nwin, t_tok, C), normal(n, j, nwin, t_tok, C)
    w_att = normal(n, j, HEADS, D, D, scale=D ** -0.5)
    w_msg = normal(n, j, HEADS, D, D, scale=D ** -0.5)
    bias = normal(HEADS, t_tok, t_tok)
    mask = (rng.uniform(size=(n, j, nwin, t_tok)) > 0.3).astype(np.float32)
    mask[0, :, 1] = 0.0  # window 1 of receiver 0: every key masked
    return q, k, v, w_att, w_msg, bias, mask


@pytest.mark.parametrize("j", [1, 3])
def test_typed_twin_vs_pallas_and_oracle(j):
    args = _typed_inputs(20 + j, j=j)
    jargs = tuple(map(jnp.asarray, args))
    got = pwa.fused_window_attention(*map(t, args), HEADS, D).numpy()
    pallas = np.asarray(jwa.hetero_window_attention(
        *jargs, heads=HEADS, dim_head=D, interpret=True))
    oracle = np.asarray(jwa.hetero_window_attention_xla(
        *jargs, heads=HEADS, dim_head=D))
    assert got.shape == pallas.shape == args[0].shape
    close(got, pallas, TYPED_ATOL)
    close(got, oracle, TYPED_ATOL)
    assert np.all(got[0, 1] == 0.0)  # the fully masked window


def test_typed_twin_ignores_masked_sender():
    """A sender masked everywhere contributes nothing, whatever it holds."""
    q, k, v, w_att, w_msg, bias, mask = _typed_inputs(31)
    mask[:, 2] = 0.0
    base = pwa.fused_window_attention(*map(t, (q, k, v, w_att, w_msg, bias,
                                               mask)), HEADS, D)
    k[:, 2], v[:, 2] = 999.0, 999.0
    poisoned = pwa.fused_window_attention(
        *map(t, (q, k, v, w_att, w_msg, bias, mask)), HEADS, D)
    close(poisoned, base.numpy(), TYPED_ATOL)
    assert torch.isfinite(base).all()


def test_typed_attention_grads_match_oracle_grads():
    """The wrapper's backward (recompute through the twin) against
    jax.grad of the JAX oracle, for every differentiable input."""
    args = _typed_inputs(41, n=1, j=2, nwin=2)
    mask = args[-1]
    leaves = [t(a).requires_grad_() for a in args[:-1]]
    pwa.fused_window_attention(*leaves, t(mask), HEADS, D).square().sum() \
        .backward()

    def loss(*a):
        out = jwa.hetero_window_attention_xla(*a, jnp.asarray(mask),
                                              heads=HEADS, dim_head=D)
        return jnp.sum(out * out)

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *map(jnp.asarray, args[:-1]))
    for leaf, g in zip(leaves, want):
        close(leaf.grad, g, 1e-4)
        assert float(leaf.grad.abs().sum()) > 0


@pytest.mark.parametrize("bad", ["v_shape", "w_att_shape", "w_msg_shape",
                                 "mask_shape", "bias_shape", "heads",
                                 "dtype", "too_many_keys"])
def test_typed_launch_rejects_malformed_inputs(bad):
    """Every shape and type the typed kernel indexes with is checked
    before a pointer reaches the device (no kernel is built here)."""
    j = 21 if bad == "too_many_keys" else 3  # 21 * 16 keys > 320
    q, k, v, w_att, w_msg, bias, mask = map(t, _typed_inputs(0, j=j))
    heads, error = HEADS, ValueError
    if bad == "v_shape":
        v = v[:, :2]
    elif bad == "w_att_shape":
        w_att = w_att[..., :-1]
    elif bad == "w_msg_shape":
        w_msg = w_msg[:, :, :1]
    elif bad == "mask_shape":
        mask = mask[:, :, :-1]
    elif bad == "bias_shape":
        bias = bias[:, :-1]
    elif bad == "heads":
        heads = HEADS + 1
    elif bad == "dtype":
        w_att, error = w_att.to(torch.bfloat16), TypeError
    with pytest.raises(error):
        pwa.typed_window_attention_launch(q, k, v, w_att, w_msg, bias, mask,
                                          heads, D)
