"""Tensor ops of the reference, copied from the port: each kernel wrapper
runs its plain PyTorch twin (:func:`use_kernel` is always False here).
A twin's backward is its own autograd graph; :func:`twin_backward`
names the profiler range the port puts around it."""
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
    """Always False in the reference: every wrapper runs its twin."""
    return False


TWIN_BACKWARD = "twin_backward:"


def twin_backward(kernel: str):
    """Profiler range around the backward of ``kernel``'s wrapper: its
    plain twin's forward recompute and backward."""
    import torch

    return torch.profiler.record_function(TWIN_BACKWARD + kernel)
