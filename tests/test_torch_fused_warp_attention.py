"""Port parity: the fused warp + attention wrapper's plain twin vs the
JAX package, at the 64^2 shapes of tests/test_fused_warp_attention.py.

The twin (pair-warp twin, window split, plain attention twin, merge) is
held against the Pallas fused kernel in interpret mode and against the
JAX oracle ``warp_window_attention_xla`` within 1e-4 absolute: float32
attention over unit-normal maps whose warp coordinates the two
frameworks round ~1e-5 px apart (the bar of the pair-warp cases in
test_torch_warp.py; the scores here are kept at unit variance so the
softmax does not amplify it).  The wrapper's backward is held against
jax.grad of the oracle for q, src_typed and bias.

The kernel's bfloat16 route runs on the tensor cores and cannot run
without a card: its numerics are emulated here — the pair-warp twin in
bfloat16 (pass 1 and the output rounded as the kernel rounds the rows it
stages), then the stripe emulation of ``test_torch_window_attention`` —
and held to the twin, the JAX oracle and the Pallas fused kernel in
interpret mode at the on-card tolerance of 0.125."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops import fused_warp_attention as jfwa
from hmvit_tpu_torch.ops import fused_warp_attention as pfwa
from hmvit_tpu_torch.ops.fused_warp import pair_warp_coefficients
from hmvit_tpu_torch.ops.fused_warp import pair_warp_xla
from test_torch_window_attention import mma_stripe_emulation
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


BF16_ATOL = 0.125  # the fused kernel's bfloat16 tolerance on the card
MMA_D = 32


def mma_fused_emulation(q, src, pair, mode, mask, bias, win, heads, d,
                        discrete_ratio, downsample_rate, num_receivers=None):
    """The fused kernel's tensor-core route: the rows it stages are the
    pair warp's bfloat16 output, and the rest is the stripe kernel."""
    l, h, w, ck2 = src.shape[2:]
    kv_pair = pair_warp_xla(src, pair, mode, discrete_ratio, downsample_rate,
                            num_receivers)
    assert kv_pair.dtype == torch.bfloat16
    return mma_stripe_emulation(q, kv_pair.reshape(q.shape[0], l, h, w, ck2),
                                bias, mask, win, heads, d)


@pytest.mark.parametrize("j", [1, 4, 5])
def test_mma_fused_emulation(j):
    """T = 64, d = 32, two receivers of J senders on 64^2 maps: sender 0
    masked in a whole stripe of windows, receiver 0's window 0 masked
    for every sender."""
    rng = np.random.default_rng(400 + j)
    r, c = min(j, 2), HEADS * MMA_D
    bf16 = torch.bfloat16
    src = t(rng.standard_normal((B, 2, j, H, H, 2 * c)).astype(
        np.float32)).to(bf16)
    q = t((rng.standard_normal((B * r, H, H, c)) * MMA_D ** -0.5).astype(
        np.float32)).to(bf16)
    bias = t((rng.standard_normal((HEADS, T, T)) * 0.5).astype(
        np.float32)).to(bf16)
    pair = t(rigid_pairwise(rng, B, j, max_t=6.0))
    mode = t(rng.integers(0, 2, (B, j)).astype(np.int32))
    mask = (rng.uniform(size=(B * r, j, H, H)) > 0.2).astype(np.float32)
    mask[:, 0, WIN:2 * WIN] = 0.0
    mask[0, :, :WIN, :WIN] = 0.0
    mask = t(mask).to(bf16)
    args = (WIN, HEADS, MMA_D, 1.0, 1.0, r)
    got = mma_fused_emulation(q, src, pair, mode, mask, bias, *args)

    def jbf16(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    jargs = (jbf16(q), jbf16(src), jnp.asarray(pair.numpy()),
             jnp.asarray(mode.numpy()), jbf16(mask), jbf16(bias))
    refs = {
        "twin": pfwa.warp_window_attention_xla(q, src, pair, mode, mask,
                                               bias, *args).float().numpy(),
        "JAX oracle": np.asarray(jfwa.warp_window_attention_xla(
            *jargs, *args).astype(jnp.float32)),
        "Pallas (interpret)": np.asarray(jfwa.warp_window_attention(
            *jargs, *args, interpret=True).astype(jnp.float32)),
    }
    assert got.dtype == bf16 and got.shape == q.shape
    errs = {what: float(np.abs(got.float().numpy() - ref).max())
            for what, ref in refs.items()}
    print(f"fused J={j}: max abs error " + ", ".join(
        f"{what} {e:.4f}" for what, e in errs.items()))
    assert all(e <= BF16_ATOL for e in errs.values()), errs
    assert torch.all(got[0, :WIN, :WIN] == 0)
    assert torch.isfinite(got.float()).all()


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
