"""Tensor ops of the port.  Each hand-written kernel sits behind a
wrapper that launches it for CUDA tensors and runs the kernel's plain
PyTorch twin for CPU tensors.  :func:`plain_ops` forces the twins on
CUDA tensors too — the comparison hook for tests and ``chip_smoke.py``,
never a fallback.  A kernel's backward is its twin's recompute, inside a
profiler range :func:`hmvit_tpu_torch.tracing.twin_backward` names
(``tools/profile.py --ranges`` rolls the device time up by it)."""
from __future__ import annotations

import contextlib
import contextvars

_PLAIN = contextvars.ContextVar("hmvit_tpu_torch_plain_ops", default=False)


@contextlib.contextmanager
def plain_ops():
    """Run every kernel wrapper's plain PyTorch twin inside the block."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(x) -> bool:
    """True when ``x`` lies on a CUDA device and :func:`plain_ops` is off."""
    return bool(x.is_cuda) and not _PLAIN.get()

