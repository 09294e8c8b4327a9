"""Small constant tensors on the device, made once.

``torch.tensor(values, device="cuda")`` copies from pageable host memory
and waits for the copy: on every call of the serving forward it is a
blocking host-to-device transfer, and inside a CUDA-graph capture it is
an error.  :func:`device_constant` makes each such tensor at its first
call (a warm-up, before any capture) and hands back the same tensor
after, so the forward then issues no host-to-device copy at all."""
from __future__ import annotations

import functools

import torch


def device_constant(values, dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made once per
    (values, dtype, device): ``values`` is a number or nested tuples of
    numbers (hashable).  The tensor is shared by every caller: never write
    to it.  The cache holds one tensor per distinct key, and the keys
    are the model's static geometry, so it stays small."""
    return _cached(values, dtype, torch.device(device))


@functools.lru_cache(maxsize=None)
def _cached(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)
