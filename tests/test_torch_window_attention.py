"""Port parity: the window-attention kernels' plain twins vs the Pallas
kernels in interpret mode (stripe_window_attention, plain_window_
attention, and the typed hetero_window_attention with its XLA oracle),
with masked senders, fully masked query rows (which must emit zeros)
and J in {1, 3}.  Float32, 2e-5 absolute (1e-5 for the typed kernel):
softmax-attention of unit-normal inputs in another summation order.
Gradients of the typed wrapper are held to jax.grad of the oracle
(1e-4).  The camera branch's WindowSelfAttention (the plain kernel with
J = 1) is held against its flax module too.

The bfloat16 tensor-core body of the stripe, plain and typed kernels
(``csrc/attention_mma.cuh``) cannot run without a card, so its NUMERICS
are emulated here in plain PyTorch — per-sender online softmax, bf16
rounding exactly where the kernel rounds — and held, at the kernel
checks' bfloat16 tolerance of 0.0313, to the twins, the JAX oracles and
the Pallas kernels in interpret mode (the stripe kernel: window split,
emulation, merge); and the rule that sends a launch to one body or the
other is held to its mirror in the wrapper, for every entry point."""
import re

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


# ---- the tensor-core body: numerics emulated, body rule mirrored --------

BF16_ATOL = 0.0313  # the bfloat16 tolerance of the kernel checks on the card
MMA_HEADS, MMA_D, MMA_T, MMA_NWIN = 2, 32, 64, 8


def _bf16_parts(x, parts):
    """x as the sum of ``parts`` bf16 values, each held in float32."""
    hi = x.to(torch.bfloat16).float()
    return [hi] if parts == 1 else [hi, (x - hi).to(torch.bfloat16).float()]


def mma_body_emulation(q, k, v, bias, mask, heads, d, w_att=None, w_msg=None,
                       qw_parts=2):
    """What ``attention_mma.cuh`` computes, rounding where it rounds: the
    keys one sender at a time with a running max and sum in float32; the
    untyped form rounds P to bf16 once; the typed form carries q W_att, P
    and P . V as hi + lo bf16 parts and applies W_msg^T to the sender's
    P . V; the row sum adds the float32 P; a row whose max is <= -5e8
    emits zeros; one rounding to bf16 at the end.  bf16 x bf16 products
    summed in float32 are exact up to the summation order."""
    typed = w_att is not None
    n, nwin, t, c = q.shape
    j = k.shape[1]
    qh = q.float().reshape(n, nwin, t, heads, d).permute(0, 1, 3, 2, 4)
    kh = k.float().reshape(n, j, nwin, t, heads, d).permute(0, 1, 2, 4, 3, 5)
    vh = v.float().reshape(n, j, nwin, t, heads, d).permute(0, 1, 2, 4, 3, 5)
    m = torch.full((n, nwin, heads, t), -float("inf"))
    l = torch.zeros_like(m)
    o = torch.zeros(n, nwin, heads, t, d)
    for jj in range(j):
        if typed:
            qw = torch.einsum("nwhtd,nhde->nwhte", qh, w_att[:, jj].float())
            s = sum(torch.einsum("nwhte,nwhse->nwhts", part, kh[:, jj])
                    for part in _bf16_parts(qw, qw_parts))
        else:
            s = torch.einsum("nwhtd,nwhsd->nwhts", qh, kh[:, jj])
        s = torch.where(mask[:, jj, :, None, None, :] > 0,
                        s + bias.float()[None, None], torch.tensor(-1e9))
        m_new = torch.maximum(m, s.amax(-1))
        scale = torch.exp(m - m_new)
        m = m_new
        p = torch.exp(s - m[..., None])
        l = l * scale + p.sum(-1)
        pv = sum(torch.einsum("nwhts,nwhsd->nwhtd", part, vh[:, jj])
                 for part in _bf16_parts(p, 2 if typed else 1))
        if typed:
            pv = sum(torch.einsum("nwhte,nhde->nwhtd", part,
                                  w_msg[:, jj].float())
                     for part in _bf16_parts(pv, 2))
        o = o * scale[..., None] + pv
    out = torch.where((m <= -5e8)[..., None], torch.zeros(()),
                      o / l[..., None])
    return out.permute(0, 1, 3, 2, 4).reshape(n, nwin, t, c).to(q.dtype)


def mma_stripe_emulation(q, kv, bias, mask, win, heads, d):
    """The stripe kernel on the tensor-core body: the same units in the
    same order as the plain kernel, read through another address map, so
    window split -> :func:`mma_body_emulation` -> merge.  q (N, H, W, C),
    kv (N, J, H, W, 2C), mask (N, J, H, W)."""
    h, w, c = q.shape[1:]
    kvw = pwa._split_local(kv, win)
    out = mma_body_emulation(
        pwa._split_local(q, win), kvw[..., :c], kvw[..., c:], bias,
        pwa._split_local(mask[..., None], win)[..., 0], heads, d)
    return pwa._merge_local(out, win, h, w)


def _mma_inputs(j, seed):
    """Unit-normal bfloat16 operands as the on-card check draws them (q
    unscaled, bias at 0.5, relation matrices at d ** -0.5), the first
    sender fully masked in window 1 and every key of receiver 0's
    window 0 masked."""
    rng = np.random.default_rng(seed)
    n, c = 2, MMA_HEADS * MMA_D

    def normal(*shape, scale=1.0):
        x = (rng.standard_normal(shape) * scale).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16)

    q = normal(n, MMA_NWIN, MMA_T, c)
    k = normal(n, j, MMA_NWIN, MMA_T, c)
    v = normal(n, j, MMA_NWIN, MMA_T, c)
    w_att = normal(n, j, MMA_HEADS, MMA_D, MMA_D, scale=MMA_D ** -0.5)
    w_msg = normal(n, j, MMA_HEADS, MMA_D, MMA_D, scale=MMA_D ** -0.5)
    bias = normal(MMA_HEADS, MMA_T, MMA_T, scale=0.5)
    mask = (rng.uniform(size=(n, j, MMA_NWIN, MMA_T)) > 0.3).astype(
        np.float32)
    mask[:, 0, 1] = 0.0
    mask[0, :, 0] = 0.0
    return q, k, v, w_att, w_msg, bias, torch.from_numpy(mask).to(
        torch.bfloat16)


def _jbf16(x):
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def _as_f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


def _held(name, got, refs):
    errs = {what: float(np.abs(_as_f32(got) - _as_f32(ref)).max())
            for what, ref in refs.items()}
    print(f"{name}: max abs error " + ", ".join(
        f"{what} {e:.4f} (margin {BF16_ATOL - e:.4f})"
        for what, e in errs.items()))
    for what, e in errs.items():
        assert e <= BF16_ATOL, (name, what, e)


@pytest.mark.parametrize("j", [1, 4, 5])
def test_mma_body_emulation_plain(j):
    q, k, v, _, _, bias, mask = _mma_inputs(j, 100 + j)
    got = mma_body_emulation(q, k, v, bias, mask, MMA_HEADS, MMA_D)
    kv = torch.cat([k, v], dim=-1)
    jargs = tuple(map(_jbf16, (q, k, v, bias, mask)))
    _held(f"untyped J={j}", got, {
        "twin": pwa.plain_window_attention_xla(q, k, v, bias, mask,
                                               MMA_HEADS, MMA_D),
        "JAX oracle": jwa.plain_window_attention_xla(
            *jargs, heads=MMA_HEADS, dim_head=MMA_D),
        "Pallas (interpret)": jwa.plain_window_attention(
            jargs[0], _jbf16(kv), *jargs[3:], heads=MMA_HEADS,
            dim_head=MMA_D, interpret=True, w_block=MMA_NWIN)})
    assert got.dtype == torch.bfloat16
    assert torch.all(got[0, 0] == 0)  # every key masked: zeros
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("j", [1, 4, 5])
def test_mma_body_emulation_stripe(j):
    """The stripe layout at T = 64, d = 32 on 16 x 32 maps (8 windows):
    window 1's first sender and every key of map 0's window 0 masked."""
    q, k, v, _, _, bias, mask = _mma_inputs(j, 300 + j)
    win, h, w = 8, 16, 32
    q, kv, mask = (pwa._merge_local(z, win, h, w) for z in (
        q, torch.cat([k, v], dim=-1), mask[..., None]))
    mask = mask[..., 0]
    got = mma_stripe_emulation(q, kv, bias, mask, win, MMA_HEADS, MMA_D)
    # the JAX oracle takes split windows: the test's own k, v and mask
    oracle = jwa.plain_window_attention_xla(
        _jbf16(pwa._split_local(q, win)), _jbf16(k), _jbf16(v), _jbf16(bias),
        _jbf16(pwa._split_local(mask[..., None], win)[..., 0]),
        heads=MMA_HEADS, dim_head=MMA_D)
    _held(f"stripe J={j}", got, {
        "twin": pwa.stripe_window_attention_xla(q, kv, bias, mask, win,
                                                MMA_HEADS, MMA_D),
        "JAX oracle": pwa._merge_local(torch.tensor(_as_f32(oracle)),
                                       win, h, w),
        "Pallas (interpret)": jwa.stripe_window_attention(
            *map(_jbf16, (q, kv, bias, mask)), win=win, heads=MMA_HEADS,
            dim_head=MMA_D, interpret=True)})
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.all(got[0, :win, :win] == 0)  # every key masked: zeros
    assert torch.isfinite(got.float()).all()


@pytest.mark.parametrize("j", [1, 4, 5])
def test_mma_body_emulation_typed(j):
    args = _mma_inputs(j, 200 + j)
    q, k, v, w_att, w_msg, bias, mask = args
    got = mma_body_emulation(q, k, v, bias, mask, MMA_HEADS, MMA_D, w_att,
                             w_msg)
    jargs = tuple(map(_jbf16, args))
    _held(f"typed J={j}", got, {
        "twin": pwa.hetero_window_attention_xla(*args, MMA_HEADS, MMA_D),
        # the typed oracle computes in its inputs' type: it gets the
        # same bf16 values as float32
        "JAX oracle": jwa.hetero_window_attention_xla(
            *(a.astype(jnp.float32) for a in jargs), heads=MMA_HEADS,
            dim_head=MMA_D),
        "Pallas (interpret)": jwa.hetero_window_attention(
            *jargs, heads=MMA_HEADS, dim_head=MMA_D, interpret=True)})
    assert torch.all(got[0, 0] == 0)
    assert torch.isfinite(got.float()).all()


def test_one_bf16_rounding_of_typed_queries_breaks_the_tolerance():
    """Why q W_att travels as two parts: rounded to bf16 once, the same
    inputs leave the tolerance the kernel is held to."""
    args = _mma_inputs(4, 204)
    q, k, v, w_att, w_msg, bias, mask = args
    want = pwa.hetero_window_attention_xla(*args, MMA_HEADS, MMA_D).float()
    got = mma_body_emulation(q, k, v, bias, mask, MMA_HEADS, MMA_D, w_att,
                             w_msg, qw_parts=1).float()
    err = float((got - want).abs().max())
    print(f"typed queries rounded to bf16 once: max abs error {err:.4f}")
    assert err > BF16_ATOL


def _rule_constants():
    """The limits of the tensor-core body as the C sources state them."""
    from hmvit_tpu_torch.ops import cuda

    text = (cuda.CSRC_DIR / "attention_mma.cuh").read_text()
    return {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kMaxT", "kMaxKeys")}


@pytest.mark.parametrize("dtype,j,t,d,body", [
    (torch.bfloat16, 4, 64, 32, "mma"),    # serving: grid, ego
    (torch.bfloat16, 1, 64, 32, "mma"),    # serving: camera
    (torch.bfloat16, 5, 64, 32, "mma"),    # 320 keys: the most
    (torch.bfloat16, 3, 16, 16, "mma"),    # the smallest tile
    (torch.bfloat16, 2, 128, 64, "mma"),   # the widest
    (torch.bfloat16, 2, 144, 32, "simt"),  # T over 128
    (torch.bfloat16, 3, 64, 8, "simt"),    # d no multiple of 16
    (torch.bfloat16, 3, 24, 32, "simt"),   # T no multiple of 16
    (torch.bfloat16, 3, 64, 24, "simt"),
    (torch.float32, 4, 64, 32, "simt"),    # float32: always the fp32 body
    (torch.float32, 3, 16, 16, "simt"),
])
def test_attention_body_rule(dtype, j, t, d, body):
    assert pwa.attention_body(dtype, j, t, d) == body


@pytest.mark.parametrize("dtype,j,win,d,body", [
    (torch.bfloat16, 4, 8, 32, "mma"),    # serving: local phases
    (torch.bfloat16, 5, 8, 32, "mma"),    # 320 keys
    (torch.bfloat16, 3, 4, 16, "mma"),    # window 4: 16-key units
    (torch.bfloat16, 3, 8, 8, "simt"),    # d no multiple of 16
    (torch.bfloat16, 2, 6, 32, "simt"),   # T = 36: no multiple of 16
    (torch.bfloat16, 2, 12, 32, "simt"),  # T = 144: over 128
    (torch.float32, 4, 8, 32, "simt"),    # float32: always the fp32 body
])
@pytest.mark.parametrize("entry", ["stripe", "fused"])
def test_attention_body_rule_stripe_and_fused_entries(dtype, j, win, d, body,
                                                      entry, monkeypatch):
    """The stripe and the fused warp + attention launches ask the same
    rule with their own type and shape (no kernel is built here), and
    their C entry points choose by it."""
    from hmvit_tpu_torch.ops import cuda
    from hmvit_tpu_torch.ops import fused_warp_attention as pfwa

    asked, rule_of = [], pwa.attention_body

    def spy(*args):
        asked.append((args, rule_of(*args)))
        return asked[-1][1]

    heads, size = 2, 2 * win
    c = heads * d
    q = torch.zeros(j, size, size, c, dtype=dtype)
    bias = torch.zeros(heads, win * win, win * win, dtype=dtype)
    mask = torch.ones(j, j, size, size, dtype=dtype)
    if entry == "stripe":
        monkeypatch.setattr(pwa, "attention_body", spy)
        launch, out = pwa.stripe_window_attention_launch(
            q, torch.zeros(j, j, size, size, 2 * c, dtype=dtype), bias, mask,
            win, heads, d)
        symbol, source = "hm_stripe_window_attention", "window_attention.cu"
        rule = "hm_attention_body_rule(dtype, nj, t, d) == 1"
    else:
        monkeypatch.setattr(pfwa, "attention_body", spy)
        launch, out = pfwa.warp_window_attention_launch(
            q, torch.zeros(1, 2, j, size, size, 2 * c, dtype=dtype),
            torch.eye(4).repeat(1, j, j, 1, 1),
            torch.zeros(1, j, dtype=torch.long), mask, bias, win, heads, d,
            0.4, 4)
        symbol, source = ("hm_warp_window_attention",
                          "fused_warp_attention.cu")
        rule = "hm_attention_body_rule(dtype, nj, win * win, d) == 1"
    assert asked == [((dtype, j, win * win, d), body)]
    assert out.shape == q.shape and out.dtype == dtype
    text = (cuda.CSRC_DIR / source).read_text()
    entry_body = text[text.index(f'extern "C" int {symbol}('):]
    assert rule in entry_body and "hm::aligned16(" in entry_body
    # the tensor-core launch is counted as body 1, the other entry as 0
    assert re.search(r"hm::counted\((0|kFusedKernel), 1,", entry_body)
    assert f"return {symbol}_simt(" in entry_body


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("j,t,d", [(6, 64, 32), (1, 336, 32), (2, 64, 80),
                                   (2, 64, 6), (2, 18, 32), (0, 64, 32)])
def test_attention_body_rule_rejects(dtype, j, t, d):
    """What neither body takes raises, whatever the type: no shape sends
    a launch to a plain version."""
    with pytest.raises(ValueError, match="window attention kernel takes"):
        pwa.attention_body(dtype, j, t, d)


def test_attention_body_rule_mirrors_the_c_sources():
    """The wrapper's mirror and the C entry points read the same limits,
    and the C rule is where the choice is made."""
    from hmvit_tpu_torch.ops import cuda

    assert _rule_constants() == {"kMaxT": 128, "kMaxKeys": 320}
    assert pwa.attention_body(torch.bfloat16, 2, 128, 64) == "mma"
    assert pwa.attention_body(torch.bfloat16, 1, 144, 64) == "simt"
    entry = (cuda.CSRC_DIR / "window_attention.cu").read_text()
    body = (cuda.CSRC_DIR / "window_attention_mma.cu").read_text()
    assert "hm::shape_takes_mma(nj, t, d)" in entry
    # one rule for all four entry points
    assert entry.count("hm_attention_body_rule(dtype, nj, t, d) == 1") == 3
    fused = (cuda.CSRC_DIR / "fused_warp_attention.cu").read_text()
    assert "hm_attention_body_rule(dtype, nj, win * win, d) == 1" in fused
    assert re.search(r"t % 16 == 0 && t <= mma::kMaxT && d > 0 &&\s+"
                     r"d % 16 == 0 && d <= 64 && nj \* t <= mma::kMaxKeys",
                     body)
    with pytest.raises(TypeError):
        pwa.attention_body(torch.float16, 2, 64, 32)


def test_tensor_core_instructions_are_written_in_the_sources():
    """The products of the bfloat16 lane are mma.sync instructions fed by
    ldmatrix and staged by 16-byte cp.async, in the repository's own
    source; the previous body stays reachable for timing only."""
    from hmvit_tpu_torch.ops import cuda

    text = (cuda.CSRC_DIR / "attention_mma.cuh").read_text()
    for needle in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
                   "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16",
                   "cp.async.cg.shared.global [%0], [%1], 16;"):
        assert needle in text, needle
    assert len(cuda.SIMT_KERNELS) == len(cuda.ATTENTION_KERNELS) == 4
    for name, simt in zip(cuda.ATTENTION_KERNELS, cuda.SIMT_KERNELS):
        assert simt.symbol == cuda.KERNELS[name].symbol + "_simt"
        assert simt.argtypes == cuda.KERNELS[name].argtypes
    assert not any(k.symbol.endswith("_simt") for k in cuda.KERNELS.values())
    counts = cuda.attention_body_launches()  # no library here: all zero
    assert set(counts) == set(cuda.ATTENTION_KERNELS)
    assert all(set(c) == {"simt", "mma"} for c in counts.values())
