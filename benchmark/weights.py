"""Seeded weights, made by the benchmark on the device and handed alike to
the program and to the reference.

Every floating parameter and statistic of a model's ``state_dict``, in
the sorted order of their names, takes its slice of ONE normal draw of a
``torch.Generator`` on the device, scaled by a rule on its name and
shape (the flax defaults' scales, with small random offsets where flax
puts constants, so that no bias or norm scale goes untested):

* a weight of two or more axes, or a ``kernel``: ``z / sqrt(fan_in)``,
  fan_in the product of its axes after the first (a typed ``kernel``
  (types, in, out): ``in``; a relation matrix: its second-to-last axis);
* ``running_var``: ``1 + 0.05 |z|``; a 1-axis ``weight`` or a ``scale``
  (norm scales): ``1 + 0.02 z``;
* everything else (biases, running means, position tables): ``0.02 z``.

Integer buffers (index tables) stay as the model built them.
"""
from __future__ import annotations

import math

import torch


def _scale(name: str, shape: tuple) -> tuple[float, float, bool]:
    """(offset, std, absolute) of one tensor: value = offset + std * z
    (|z| where ``absolute``)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return 1.0, 0.05, True
    if leaf.startswith("relation_"):
        return 0.0, 1.0 / math.sqrt(shape[-2]), False
    if leaf == "kernel" and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(shape[-2]), False
    if leaf == "weight" and len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:])), False
    if leaf in ("weight", "scale"):
        return 1.0, 0.02, False
    return 0.0, 0.02, False


def make_weights(shapes: dict, seed: int, device, dtype) -> dict:
    """{name: tensor of ``dtype`` on ``device``} for ``shapes`` ({name:
    shape} of the floating entries of a state_dict), from ``seed``."""
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(sum(sizes), generator=gen, device=device,
                    dtype=torch.float32)
    out = {}
    for name, part in zip(names, torch.split(z, sizes)):
        offset, std, absolute = _scale(name, tuple(shapes[name]))
        part = part.abs() if absolute else part
        out[name] = (offset + std * part).reshape(shapes[name]).to(dtype)
    return out


def float_shapes(model: torch.nn.Module) -> dict:
    """{name: shape} of the floating entries of ``model``'s state_dict."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if v.is_floating_point()}


def load(model: torch.nn.Module, weights: dict) -> torch.nn.Module:
    """Copy ``weights`` into ``model`` (every floating entry of its
    state_dict, in each entry's own dtype)."""
    state = model.state_dict()
    missing = sorted(set(float_shapes(model)) ^ set(weights))
    if missing:
        raise KeyError(f"weights and model differ in {missing[:8]}")
    with torch.no_grad():
        for k, v in weights.items():
            state[k].copy_(v)
    return model
