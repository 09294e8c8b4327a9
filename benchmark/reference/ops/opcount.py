"""Operation counts of the hand-written kernels, from their shapes.

PyTorch's ``FlopCounterMode`` counts the library's matrix products and
convolutions but cannot see inside a kernel launched through ctypes, so
a FLOP count of the forward adds these.  The same formulas give each
kernel's operation bound in ``chip_smoke.py``.  A multiply-add counts
as 2 operations, as the counter counts it.

:func:`record_kernel_ops` collects the count of every kernel wrapper
called inside it, whichever route the wrapper takes; the plain twins
that run there on CPU tensors are hidden from PyTorch's dispatch modes,
so a ``FlopCounterMode`` over the same block counts each kernel once,
by its formula, on the CPU as on the card.
"""
from __future__ import annotations

import contextlib
import contextvars

_RECORD = contextvars.ContextVar("hmvit_tpu_torch_kernel_ops", default=None)


def attention_ops(n: int, windows: int, t: int, senders: int, heads: int,
                  dim_head: int, typed: bool = False) -> float:
    """Window attention of ``n`` maps of ``windows`` windows of ``t``
    tokens, each attending over ``senders`` windows of keys: q k^T and
    p v per (map, window, head); typed also projects q by W_att and v by
    W_msg per sender."""
    per_head = 4 * t * senders * t * dim_head
    if typed:
        per_head += 4 * senders * t * dim_head * dim_head
    return float(n * windows * heads * per_head)


def pair_warp_ops(maps: int, senders: int, h: int, w: int,
                  channels: int) -> float:
    """Bilinear warp of ``senders`` maps into each of ``maps`` receiver
    frames: 4 taps, each a multiply-add and its weight, per output
    value (12 operations)."""
    return 12.0 * maps * senders * h * w * channels


@contextlib.contextmanager
def record_kernel_ops():
    """Context: yields the list of (kernel name, operations) of every
    kernel wrapper called inside the block."""
    calls = []
    token = _RECORD.set(calls)
    try:
        yield calls
    finally:
        _RECORD.reset(token)


def note(name: str, ops: float):
    """Record one wrapper call (no-op outside :func:`record_kernel_ops`)."""
    calls = _RECORD.get()
    if calls is not None:
        calls.append((name, float(ops)))


def hidden():
    """Context around a plain twin's run: while recording, PyTorch's
    dispatch modes (a ``FlopCounterMode``) do not see it."""
    if _RECORD.get() is None:
        return contextlib.nullcontext()
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()


def _bmm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    """``bmm``'s count for every overload: ``bmm(a, b, out_dtype)`` (the
    float32-result product of ``utils.precision.dot_f32``) passes its
    dtype where the library's formula takes the output's shape."""
    from torch.utils.flop_counter import bmm_flop

    return bmm_flop(a_shape, b_shape)


def flop_counter():
    """A ``FlopCounterMode`` (no display) that also counts ``bmm`` with
    an ``out_dtype``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    return FlopCounterMode(display=False,
                           custom_mapping={torch.ops.aten.bmm: _bmm_flop})
