"""Multi-sender window attention (port of
``hmvit_tpu/ops/window_attention.py``).

Three kernel wrappers over the C entry points of
``csrc/window_attention.cu``.  Every entry point runs bfloat16 operands
on the tensor cores (``csrc/window_attention_mma.cu``) and float32 ones
on the fp32 CUDA cores; :func:`attention_body` says which shapes go
where.

* :func:`fused_stripe_window_attention` — local windows read straight
  from unsplit (N, H, W, C) maps (replaces the Pallas
  ``_stripe_kernel``);
* :func:`fused_plain_window_attention` — pre-split (N, Wn, T, C) windows
  (replaces the Pallas ``_plain_kernel``);
* :func:`fused_window_attention` — the typed form, with per-pair
  relation matrices applied to q and v inside the kernel (replaces the
  Pallas ``_kernel`` of ``hetero_window_attention``).

For CPU tensors, or under :func:`hmvit_tpu_torch.ops.plain_ops`, each
runs its plain twin — :func:`plain_window_attention_xla` and
:func:`hetero_window_attention_xla`, the JAX package's oracles.
Backward passes recompute through the twins.  Every input q arrives
pre-scaled by dim_head ** -0.5.
"""
from __future__ import annotations

import torch

from . import cuda, opcount, use_kernel
from ..tracing import twin_backward


def plain_window_attention_xla(q, k, v, bias, mask, heads: int,
                               dim_head: int):
    """Plain twin: q (N, W, T, C); k, v (N, J, W, T, C); bias (heads,
    T, T); mask (N, J, W, T).  Accumulates in float32 whatever the input
    dtype; masked keys are set to -1e9, fully masked rows emit zero."""
    n, w_cnt, t, c = q.shape
    j = k.shape[1]
    d = dim_head
    f32 = torch.float32
    qh = q.reshape(n, w_cnt, t, heads, d).to(f32)
    kh = k.reshape(n, j, w_cnt, t, heads, d).to(f32)
    vh = v.reshape(n, j, w_cnt, t, heads, d).to(f32)
    sim = torch.einsum("nwthd,njwshd->njwhts", qh, kh)
    sim = sim + bias.to(f32)[None, None, None]
    sim = torch.where(mask[:, :, :, None, None, :] > 0, sim,
                      torch.full((), -1e9, dtype=f32, device=sim.device))
    sim = sim.movedim(1, -2)  # (n, w, h, t, j, s)
    flat = sim.reshape(*sim.shape[:-2], j * t)
    attn = torch.softmax(flat, dim=-1)
    attn = torch.where(flat.amax(-1, keepdim=True) <= -5e8,
                       torch.zeros_like(attn), attn)
    attn = attn.reshape(sim.shape).movedim(-2, 1)
    out = torch.einsum("njwhts,njwshd->nwthd", attn, vh)
    return out.reshape(n, w_cnt, t, heads * d).to(q.dtype)


def hetero_window_attention_xla(q, k, v, w_att, w_msg, bias, mask,
                                heads: int, dim_head: int):
    """Plain twin of the typed kernel: q (N, W, T, C); k, v (N, J, W, T,
    C); w_att, w_msg (N, J, heads, d, d); bias (heads, T, T); mask (N,
    J, W, T).  sim = (q W_att) k^T + bias over the J*T keys of each
    window, out = sum_j attn_j (v W_msg^T); float32 accumulation, masked
    keys at -1e9, fully masked rows emit zero."""
    n, w_cnt, t, c = q.shape
    j = k.shape[1]
    d = dim_head
    f32 = torch.float32
    qh = q.reshape(n, w_cnt, t, heads, d).to(f32)
    kh = k.reshape(n, j, w_cnt, t, heads, d).to(f32)
    vh = v.reshape(n, j, w_cnt, t, heads, d).to(f32)
    q_rel = torch.einsum("nwthd,njhde->njwthe", qh, w_att.to(f32))
    sim = torch.einsum("njwthe,njwshe->njwhts", q_rel, kh)
    sim = sim + bias.to(f32)[None, None, None]
    sim = torch.where(mask[:, :, :, None, None, :] > 0, sim,
                      torch.full((), -1e9, dtype=f32, device=sim.device))
    sim = sim.movedim(1, -2)  # (n, w, h, t, j, s)
    flat = sim.reshape(*sim.shape[:-2], j * t)
    attn = torch.softmax(flat, dim=-1)
    attn = torch.where(flat.amax(-1, keepdim=True) <= -5e8,
                       torch.zeros_like(attn), attn)
    attn = attn.reshape(sim.shape).movedim(-2, 1)
    v_msg = torch.einsum("njhde,njwshe->njwshd", w_msg.to(f32), vh)
    out = torch.einsum("njwhts,njwshd->nwthd", attn, v_msg)
    return out.reshape(n, w_cnt, t, heads * d).to(q.dtype)


def _split_local(z, win: int):
    """(..., H, W, ch) -> (..., (H/win)*(W/win), win*win, ch)."""
    *lead, h, w, ch = z.shape
    z = z.reshape(*lead, h // win, win, w // win, win, ch).movedim(-3, -4)
    return z.reshape(*lead, (h // win) * (w // win), win * win, ch)


def _merge_local(z, win: int, h: int, w: int):
    *lead, _, _, ch = z.shape
    z = z.reshape(*lead, h // win, w // win, win, win, ch).movedim(-3, -4)
    return z.reshape(*lead, h, w, ch)


def stripe_window_attention_xla(q, kv, bias, mask, win: int, heads: int,
                                dim_head: int):
    """Plain twin of the stripe kernel: window-split, attend, merge.
    q (N, H, W, C); kv (N, J, H, W, 2C); mask (N, J, H, W)."""
    n, h, w, c = q.shape
    kvw = _split_local(kv, win)
    out = plain_window_attention_xla(
        _split_local(q, win), kvw[..., :c], kvw[..., c:], bias,
        _split_local(mask[..., None], win)[..., 0], heads, dim_head)
    return _merge_local(out, win, h, w)


def attention_body(dtype, j: int, t: int, dim_head: int) -> str:
    """Which body of ``csrc/`` a stripe, plain, typed or fused warp +
    attention launch of this type and shape runs — the rule of the C
    entry points (``hm_attention_body_rule``), mirrored here for the
    error text and the tests.  "mma": bfloat16 on the tensor cores
    (``attention_mma.cuh``), for T a multiple of 16 up to 128, dim_head a
    multiple of 16 up to 64 and J*T <= 320.  "simt": the fp32 CUDA-core
    body (``attention_body.cuh``), for float32 and every other shape with
    J*T <= 320, dim_head <= 64 and both T and dim_head multiples of 4
    (the fused kernel: dim_head a multiple of 8), and operands that are
    not 16-byte aligned (no contiguous tensor of these shapes is).
    Raises for what no kernel takes."""
    if dtype not in cuda.DTYPE_CODES:
        raise TypeError(f"window attention: unsupported dtype {dtype}")
    if j <= 0 or t <= 0 or dim_head <= 0 or j * t > 320 or dim_head > 64:
        body = None
    elif (dtype == torch.bfloat16 and t % 16 == 0 and t <= 128
          and dim_head % 16 == 0):
        body = "mma"
    else:
        body = None if dim_head % 4 or t % 4 else "simt"
    if body is None:
        raise ValueError(
            f"window attention kernel takes J*T <= 320, dim_head <= 64 and "
            f"both T and dim_head multiples of 4 (bfloat16 with T % 16 == 0, "
            f"T <= 128 and dim_head % 16 == 0 runs on the tensor cores), got "
            f"J*T={j * t}, T={t}, d={dim_head}")
    return body


def _attention_launch(kernel, q, kv, bias, mask, heads, dim_head, nwin, t,
                      win, wcols):
    if q.dtype not in cuda.DTYPE_CODES or kv.dtype != q.dtype:
        raise TypeError(f"window attention: unsupported dtypes "
                        f"{q.dtype}/{kv.dtype}")
    n, *spatial, c = q.shape
    j = kv.shape[1]
    if (c != heads * dim_head or tuple(kv.shape) != (n, j, *spatial, 2 * c)
            or tuple(mask.shape) != (n, j, *spatial)
            or tuple(bias.shape) != (heads, t, t)):
        raise ValueError(f"window attention: inconsistent shapes q "
                         f"{tuple(q.shape)}, kv {tuple(kv.shape)}, mask "
                         f"{tuple(mask.shape)}, bias {tuple(bias.shape)} for "
                         f"{heads} heads of {dim_head}")
    attention_body(q.dtype, j, t, dim_head)
    tensors = [q.contiguous(), kv.contiguous(),
               bias.to(torch.float32).contiguous(),
               mask.to(torch.float32).contiguous(), torch.empty_like(q)]
    ints = [cuda.DTYPE_CODES[q.dtype], n, j, nwin, t, win, wcols, heads,
            dim_head]
    key = (t, str(q.dtype).split(".")[-1])  # counted by tokens and type
    return lambda: kernel.launch(tensors, ints, key=key), tensors[-1]


def stripe_window_attention_launch(q, kv, bias, mask, win, heads, dim_head,
                                   simt: bool = False):
    """Validate and lay out one stripe-kernel launch: returns
    (launch, out).  ``simt`` forces the fp32 CUDA-core body where the
    entry point would choose the tensor cores (for timing only)."""
    h, w = q.shape[1:3]
    if h % win or w % win:
        raise ValueError(f"map {(h, w)} not divisible by window {win}")
    kernel = (cuda.STRIPE_WINDOW_ATTENTION_SIMT if simt
              else cuda.STRIPE_WINDOW_ATTENTION)
    return _attention_launch(kernel, q, kv, bias, mask, heads, dim_head,
                             (h // win) * (w // win), win * win, win,
                             w // win)


def plain_window_attention_launch(q, kv, bias, mask, heads, dim_head,
                                  simt: bool = False):
    """Validate and lay out one plain-kernel launch: returns
    (launch, out).  ``simt`` as for the stripe kernel."""
    nwin, t = q.shape[1:3]
    kernel = (cuda.PLAIN_WINDOW_ATTENTION_SIMT if simt
              else cuda.PLAIN_WINDOW_ATTENTION)
    return _attention_launch(kernel, q, kv, bias, mask, heads, dim_head,
                             nwin, t, 0, 0)


def typed_window_attention_launch(q, k, v, w_att, w_msg, bias, mask, heads,
                                  dim_head, simt: bool = False):
    """Validate and lay out one typed-kernel launch: returns
    (launch, out).  ``simt`` as for the plain kernel."""
    if q.dtype not in cuda.DTYPE_CODES or any(
            x.dtype != q.dtype for x in (k, v, w_att, w_msg)):
        raise TypeError(f"typed window attention: unsupported dtypes "
                        f"{[x.dtype for x in (q, k, v, w_att, w_msg)]}")
    n, nwin, t, c = q.shape
    j = k.shape[1]
    rel = (n, j, heads, dim_head, dim_head)
    if (c != heads * dim_head or tuple(k.shape) != (n, j, nwin, t, c)
            or v.shape != k.shape or tuple(w_att.shape) != rel
            or tuple(w_msg.shape) != rel
            or tuple(mask.shape) != (n, j, nwin, t)
            or tuple(bias.shape) != (heads, t, t)):
        raise ValueError(
            f"typed window attention: inconsistent shapes q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"w_att {tuple(w_att.shape)}, w_msg {tuple(w_msg.shape)}, mask "
            f"{tuple(mask.shape)}, bias {tuple(bias.shape)} for {heads} "
            f"heads of {dim_head}")
    attention_body(q.dtype, j, t, dim_head)
    tensors = [q.contiguous(), k.contiguous(), v.contiguous(),
               w_att.contiguous(), w_msg.contiguous(),
               bias.to(torch.float32).contiguous(),
               mask.to(torch.float32).contiguous(), torch.empty_like(q)]
    ints = [cuda.DTYPE_CODES[q.dtype], n, j, nwin, t, heads, dim_head]
    kernel = (cuda.TYPED_WINDOW_ATTENTION_SIMT if simt
              else cuda.TYPED_WINDOW_ATTENTION)
    return lambda: kernel.launch(tensors, ints), tensors[-1]


def _run(prepared):
    launch, out = prepared
    launch()
    return out


def _plain_twin(q, kv, bias, mask, heads, dim_head):
    c = q.shape[-1]
    return plain_window_attention_xla(q, kv[..., :c], kv[..., c:], bias,
                                      mask, heads, dim_head)


def _recompute_grads(fn, inputs, g):
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(x.is_floating_point())
                  for x in inputs]
        out = fn(*leaves)
        diff = [x for x in leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(out, diff, g, allow_unused=True))
    return [next(grads) if x.requires_grad else None for x in leaves]


class _StripeAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias, mask, win, heads, dim_head):
        ctx.save_for_backward(q, kv, bias, mask)
        ctx.args = (win, heads, dim_head)
        return _run(stripe_window_attention_launch(q, kv, bias, mask, win,
                                                   heads, dim_head))

    @staticmethod
    def backward(ctx, g):
        win, heads, d = ctx.args
        with twin_backward("stripe_window_attention"):
            grads = _recompute_grads(
                lambda *a: stripe_window_attention_xla(*a, win, heads, d),
                ctx.saved_tensors, g)
        return (*grads, None, None, None)


class _PlainAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, bias, mask, heads, dim_head):
        ctx.save_for_backward(q, kv, bias, mask)
        ctx.args = (heads, dim_head)
        return _run(plain_window_attention_launch(q, kv, bias, mask, heads,
                                                  dim_head))

    @staticmethod
    def backward(ctx, g):
        heads, d = ctx.args
        with twin_backward("plain_window_attention"):
            grads = _recompute_grads(
                lambda *a: _plain_twin(*a, heads, d), ctx.saved_tensors, g)
        return (*grads, None, None)


class _TypedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, w_att, w_msg, bias, mask, heads, dim_head):
        ctx.save_for_backward(q, k, v, w_att, w_msg, bias, mask)
        ctx.args = (heads, dim_head)
        return _run(typed_window_attention_launch(
            q, k, v, w_att, w_msg, bias, mask, heads, dim_head))

    @staticmethod
    def backward(ctx, g):
        heads, d = ctx.args
        with twin_backward("typed_window_attention"):
            grads = _recompute_grads(
                lambda *a: hetero_window_attention_xla(*a, heads, d),
                ctx.saved_tensors, g)
        return (*grads, None, None)


def fused_window_attention(q, k, v, w_att, w_msg, bias, mask, heads: int,
                           dim_head: int):
    """Typed window attention over pre-split windows: q (N, Wn, T, C);
    k, v (N, J, Wn, T, C); w_att, w_msg (N, J, heads, d, d) relation
    matrices of each (receiver, sender) pair; bias (heads, T, T); mask
    (N, J, Wn, T).  Returns (N, Wn, T, C)."""
    n, windows, t = q.shape[:3]
    opcount.note("typed_window_attention", opcount.attention_ops(
        n, windows, t, k.shape[1], heads, dim_head, typed=True))
    if use_kernel(q):
        return _TypedAttention.apply(q, k, v, w_att, w_msg, bias, mask,
                                     heads, dim_head)
    with opcount.hidden():
        return hetero_window_attention_xla(q, k, v, w_att, w_msg, bias,
                                           mask, heads, dim_head)


def fused_stripe_window_attention(q, kv, bias, mask, win: int, heads: int,
                                  dim_head: int):
    """LOCAL window attention over unsplit maps: q (N, H, W, C), kv
    (N, J, H, W, 2C) = [K | V], bias (heads, T, T), mask (N, J, H, W).
    Returns (N, H, W, C)."""
    n, h, w = q.shape[:3]
    opcount.note("stripe_window_attention", opcount.attention_ops(
        n, (h // win) * (w // win), win * win, kv.shape[1], heads, dim_head))
    if use_kernel(q):
        return _StripeAttention.apply(q, kv, bias, mask, win, heads,
                                      dim_head)
    with opcount.hidden():
        return stripe_window_attention_xla(q, kv, bias, mask, win, heads,
                                           dim_head)


def fused_plain_window_attention(q, kv, bias, mask, heads: int,
                                 dim_head: int):
    """Window attention over pre-split windows: q (N, Wn, T, C), kv
    (N, J, Wn, T, 2C) = [K | V], bias (heads, T, T), mask (N, J, Wn, T).
    Returns (N, Wn, T, C)."""
    n, windows, t = q.shape[:3]
    opcount.note("plain_window_attention", opcount.attention_ops(
        n, windows, t, kv.shape[1], heads, dim_head))
    if use_kernel(q):
        return _PlainAttention.apply(q, kv, bias, mask, heads, dim_head)
    with opcount.hidden():
        return _plain_twin(q, kv, bias, mask, heads, dim_head)
