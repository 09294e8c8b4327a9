"""Flax-equivalent building blocks on NHWC tensors.

The JAX package builds its models from ``flax.linen`` layers; these are
their PyTorch counterparts with the same numerics:

* parameters are stored in PyTorch's layout (Dense ``(out, in)``, Conv
  OIHW, ConvTranspose ``(in, out, kh, kw)``); ``flax_leaves`` tells
  :mod:`hmvit_tpu_torch.bridge` which flax leaf each one comes from and
  how to convert it;
* computation follows flax's dtype promotion: inputs and parameters are
  promoted to their common type (a bf16 input with fp32 parameters
  computes in fp32, as flax does with ``dtype=None``);
* padding follows XLA: ``"SAME"`` pads ``(lo, hi)`` with the odd pixel
  at the end, an int pads symmetrically;
* ``reset_parameters(gen)`` draws the flax default initializer's
  distribution from an explicit ``torch.Generator``.

Train mode is ``nn.Module.train()``, as flax's ``train=True`` /
``deterministic=False``: :class:`BatchNorm` normalises with the batch's
statistics and updates its running ones by flax's rule, and
:class:`Dropout` draws its masks from the generator that
:func:`dropout_rng` installs.  :func:`remat` is flax's ``nn.remat``:
``torch.utils.checkpoint`` whose recompute replays the first pass (the
same dropout masks, no second running-statistics update).
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

_SQRT2 = math.sqrt(2.0)
# flax lecun_normal: truncated to +-2 std, rescaled by this constant so
# the truncated distribution keeps the requested variance
_TRUNC_STD = 0.87962566103423978


# config dtype names (``compute_dtype`` keys) -> torch dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def promote(*tensors) -> torch.dtype:
    """Common dtype of the non-None tensors (jnp.result_type analogue)."""
    dt = None
    for t in tensors:
        if t is None:
            continue
        dt = t.dtype if dt is None else torch.promote_types(dt, t.dtype)
    return dt


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA 'SAME' (lo, hi) padding of one axis of size n."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def gelu(x):
    """flax ``nn.gelu`` (tanh approximation, ``approximate=True``)."""
    return F.gelu(x, approximate="tanh")


def resize_nearest(x, hw: tuple[int, int]):
    """``jax.image.resize(x, (n, h, w, c), "nearest")`` on NHWC:
    source index floor((i + 0.5) * in / out) per axis."""
    n, h, w, c = x.shape
    oh, ow = hw
    return x.index_select(1, _nearest_index(h, oh, x.device)).index_select(
        2, _nearest_index(w, ow, x.device))


def _nearest_index(size: int, out: int, device):
    """min(floor((i + 0.5) * size / out), size - 1) for i < out, made on
    the device: the integer form (2 i + 1) size // (2 out) of the same
    floor, exact since the quotient lies at least 1 / (2 out) from any
    integer it is not equal to."""
    i = torch.arange(out, device=device)
    return torch.clamp((2 * i + 1) * size // (2 * out), max=size - 1)


def max_pool_same(x, k: int, s: int):
    """flax ``nn.max_pool(x, (k, k), (s, s), padding="SAME")`` on NHWC
    (-inf padding, XLA SAME split)."""
    ph = same_pads(x.shape[1], k, s)
    pw = same_pads(x.shape[2], k, s)
    xn = x.permute(0, 3, 1, 2)
    xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(xn, k, s).permute(0, 2, 3, 1)


# -- initializers drawing flax's default distributions -----------------

def lecun_normal_(t, fan_in: int, gen):
    """flax ``lecun_normal``: truncated normal, variance 1 / fan_in."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / _SQRT2))
    hi = 0.5 * (1.0 + math.erf(2.0 / _SQRT2))
    u = torch.empty(t.shape).uniform_(lo, hi, generator=gen)
    z = _SQRT2 * torch.erfinv(2.0 * u - 1.0)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        t.copy_(z * std)


def uniform_(t, lo: float, hi: float, gen):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(lo, hi, generator=gen))


def normal_(t, std: float, gen):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).normal_(0.0, std, generator=gen))


def xavier_uniform_(t, gen):
    """flax ``xavier_uniform`` (in_axis=-2, out_axis=-1, leading axes
    count as receptive field)."""
    shape = t.shape
    receptive = int(np.prod(shape)) // (shape[-1] * shape[-2])
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(3.0 * 2.0 / (fan_in + fan_out))
    uniform_(t, -limit, limit, gen)


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and statistic of ``model`` from one seeded
    CPU generator (deterministic across machines).  Children reset
    before their parents, so a parent may override a child's default
    (the detection head's prior bias)."""
    gen = torch.Generator().manual_seed(seed)
    for mod in reversed(list(model.modules())):
        reset = getattr(mod, "reset_parameters", None)
        if reset is not None:
            reset(gen)
    return model


class Dense(nn.Module):
    """flax ``nn.Dense`` on the last axis; weight ``(out, in)``."""
    flax_leaves = {"weight": ("params", "kernel", "dense"),
                   "bias": ("params", "bias", "copy")}

    def __init__(self, din: int, dout: int, use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout)) if use_bias else None

    def reset_parameters(self, gen):
        lecun_normal_(self.weight, self.weight.shape[1], gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = promote(x, self.weight, self.bias)
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


class Conv(nn.Module):
    """flax ``nn.Conv`` on NHWC; weight OIHW.  ``padding`` is "SAME" or
    a symmetric int."""
    flax_leaves = {"weight": ("params", "kernel", "conv"),
                   "bias": ("params", "bias", "copy")}

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding="SAME", use_bias: bool = True):
        super().__init__()
        self.kernel, self.stride, self.padding = kernel, stride, padding
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def reset_parameters(self, gen):
        cout, cin, k, _ = self.weight.shape
        lecun_normal_(self.weight, cin * k * k, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = promote(x, self.weight, self.bias)
        if self.padding == "SAME":
            ph = same_pads(x.shape[1], self.kernel, self.stride)
            pw = same_pads(x.shape[2], self.kernel, self.stride)
        else:
            ph = pw = (self.padding, self.padding)
        xn = x.to(dt).permute(0, 3, 1, 2)
        if any(ph) or any(pw):
            xn = F.pad(xn, (pw[0], pw[1], ph[0], ph[1]))
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(xn, self.weight.to(dt), b, stride=self.stride)
        return y.permute(0, 2, 3, 1)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` on NHWC.  With ``padding=None``: kernel
    == stride and "SAME" padding (the BEV backbone's deblocks,
    bias-free; the AutoEncoder's, with ``use_bias``), every input pixel
    painting one disjoint k x k output patch.  With an int ``padding``
    p: the lax padding ``(k-1-p, k-1-p+op)`` per axis, which is PyTorch's
    ``ConvTranspose2d(k, s, p, output_padding=op)`` (the PIXOR and
    VoxelNet deconvolutions).  Weight ``(in, out, k, k)`` holds the flax
    kernel spatially FLIPPED — flax does not flip the kernel of a
    transposed convolution, PyTorch's ``conv_transpose2d`` does."""
    flax_leaves = {"weight": ("params", "kernel", "conv_transpose"),
                   "bias": ("params", "bias", "copy")}

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 use_bias: bool = False, padding: int | None = None,
                 output_padding: tuple = (0, 0)):
        super().__init__()
        if padding is None and kernel != stride:
            raise ValueError("ConvTranspose with SAME padding supports "
                             "kernel == stride only")
        self.stride = stride
        self.padding = 0 if padding is None else padding
        self.output_padding = tuple(int(op) for op in output_padding)
        self.weight = nn.Parameter(torch.empty(cin, cout, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def reset_parameters(self, gen):
        cin, cout, k, _ = self.weight.shape
        lecun_normal_(self.weight, cin * k * k, gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = promote(x, self.weight, self.bias)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), b, stride=self.stride,
                               padding=self.padding,
                               output_padding=self.output_padding)
        return y.permute(0, 2, 3, 1)


class Conv3D(nn.Module):
    """flax ``nn.Conv`` with a 3-D kernel on NDHWC; weight OIDHW (the
    NDHWC input seen as NCDHW is channels-last-3d, cuDNN's layout).
    ``padding``: the symmetric padding of each axis (the JAX modules'
    ``((p, p), ...)``)."""
    flax_leaves = {"weight": ("params", "kernel", "conv3d"),
                   "bias": ("params", "bias", "copy")}

    def __init__(self, cin: int, cout: int, kernel=(3, 3, 3),
                 stride=(1, 1, 1), padding=(1, 1, 1),
                 use_bias: bool = True):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None

    def reset_parameters(self, gen):
        cin = self.weight.shape[1]
        lecun_normal_(self.weight, cin * int(np.prod(self.weight.shape[2:])),
                      gen)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = promote(x, self.weight, self.bias)
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv3d(x.to(dt).permute(0, 4, 1, 2, 3), self.weight.to(dt), b,
                     stride=self.stride, padding=self.padding)
        return y.permute(0, 2, 3, 4, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` on the last axis:
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``.  In eval mode
    mean and var are the running statistics; in train mode the batch's,
    over every axis but the channel, as flax computes them
    (``use_fast_variance``: float32 ``E[x^2] - E[x]^2`` clamped at 0,
    biased), and the running statistics move by flax's rule
    ``ra = momentum * ra + (1 - momentum) * stat`` (PyTorch's
    ``momentum`` is the complement, and its running variance unbiased)."""
    flax_leaves = {"weight": ("params", "scale", "copy"),
                   "bias": ("params", "bias", "copy"),
                   "running_mean": ("batch_stats", "mean", "copy"),
                   "running_var": ("batch_stats", "var", "copy")}

    def __init__(self, c: int, eps: float, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def reset_parameters(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def batch_stats(self, x):
        """Train-mode (mean, var) over every axis but the last, in float32
        from Σx, Σx² and the count."""
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        axes = tuple(range(x.ndim - 1))
        count = torch.full((1,), x.numel() // x.shape[-1], dtype=xf.dtype,
                           device=x.device)
        sums = torch.cat([xf.sum(axes), (xf * xf).sum(axes), count])
        c = x.shape[-1]
        mean = sums[:c] / sums[-1]
        var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
        return mean, var

    def forward(self, x):
        if self.training:
            mean, var = self.batch_stats(x)
            update_running_stats(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        y = x - mean
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (y * mul + self.bias).to(promote(x, self.weight, self.bias))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: eps 1e-6 by default (PyTorch's is 1e-5),
    single-pass float32 statistics ``E[x^2] - E[x]^2``."""
    flax_leaves = {"weight": ("params", "scale", "copy"),
                   "bias": ("params", "bias", "copy")}

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def reset_parameters(self, gen):
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        xf = x.to(promote(x, torch.empty((), dtype=torch.float32)))
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(promote(x, self.weight, self.bias))


# -- train mode: running statistics, dropout, remat ----------------------

# set inside a remat recompute (see :func:`remat`)
_RECOMPUTING = contextvars.ContextVar("hmvit_tpu_torch_recomputing",
                                      default=False)
# the dropout masks' generator (see :func:`dropout_rng`)
_DROPOUT_RNG = contextvars.ContextVar("hmvit_tpu_torch_dropout_rng",
                                      default=None)


def update_running_stats(module, mean, var):
    """flax's running-statistics update of a BatchNorm ``module`` in
    train mode: ``ra = momentum * ra + (1 - momentum) * stat`` in the
    buffers' type; skipped in a remat recompute, whose first pass made
    it (flax's ``nn.remat`` returns the updates of one pass)."""
    if _RECOMPUTING.get():
        return
    m = module.momentum
    with torch.no_grad():
        for ra, stat in ((module.running_mean, mean),
                         (module.running_var, var)):
            ra.copy_(m * ra + (1 - m) * stat.detach())


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator | None):
    """Run the block with ``generator`` drawing every :class:`Dropout`
    mask (the counterpart of flax's ``rngs={"dropout": key}``)."""
    token = _DROPOUT_RNG.set(generator)
    try:
        yield generator
    finally:
        _DROPOUT_RNG.reset(token)


class Dropout(nn.Module):
    """flax ``nn.Dropout``: in train mode each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the mask
    drawn from the generator of :func:`dropout_rng`; the identity in eval
    mode and at rate 0 (which draws nothing)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        gen = _DROPOUT_RNG.get()
        if gen is None:
            raise RuntimeError(
                "Dropout in train mode draws its mask from an explicit "
                "generator: run the forward under "
                "hmvit_tpu_torch.nn.dropout_rng(generator)")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def remat(module: nn.Module, *args, **kwargs):
    """``module(*args, **kwargs)`` under ``torch.utils.checkpoint``
    (non-reentrant, no early stop): its activations are recomputed in
    the backward pass instead of kept.  The recompute replays the first
    pass: it runs in the context variables of the forward (``plain_ops``,
    the kernel-operation recorder) with the module's parameters as the
    forward saw them (the bf16 copies of a ``functional_call``), draws
    the same dropout masks from a copy of the generator's state at the
    forward, and leaves the running statistics alone."""
    context = contextvars.copy_context()
    params = dict(module.named_parameters())
    gen = _DROPOUT_RNG.get()
    rng = None if gen is None else (gen.device, gen.get_state())
    calls = []

    def replay(*a):
        _RECOMPUTING.set(True)
        if rng is not None:
            again = torch.Generator(device=rng[0])
            again.set_state(rng[1])
            _DROPOUT_RNG.set(again)
        return torch.func.functional_call(module, params, a, kwargs)

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return module(*a, **kwargs)
        return context.copy().run(replay, *a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                             early_stop=False)
