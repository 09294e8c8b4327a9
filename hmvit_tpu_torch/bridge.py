"""Weight bridge: a flax ``variables`` tree -> a port module's
``state_dict``.

Port modules carry their flax counterparts' names (``Dense_0``,
``ConvBNReLU_3``, ``to_q``, ...), so a parameter's module path in the
port IS its path in the flax tree.  Each leaf class says, in
``flax_leaves``, which flax collection and leaf it reads and how:

* ``dense``: kernel (in, out) -> weight (out, in);
* ``conv``: HWIO -> OIHW;
* ``conv3d``: DHWIO -> OIDHW;
* ``conv_transpose``: (kh, kw, in, out) -> (in, out, kh, kw) with a
  spatial flip (flax does not flip a transposed convolution's kernel,
  PyTorch's ``conv_transpose2d`` does);
* ``copy``: as is — BatchNorm scale/bias/mean/var (the VoVNet's and
  BasicBlock projections' too), every bias, stacked hetero parameters
  with their type axis, ``rel_pos_bias`` (window and swap attention),
  ``relation_att``, ``relation_msg``, ``bev_embedding`` (of every camera
  encoder: (bev, bev, C), or (bev^2, C) for the deformable lift),
  ``view_embedding``.

Named sub-layers keep their flax names (the deformable lift's
``offsets`` / ``weights`` / ``value`` / ``out``, VPN's ``view_hidden`` /
``view_transform``, swap attention's ``to_qkv`` / ``to_out``), each a
Dense with the ``dense`` conversion.

Leaves of modules without ``flax_leaves`` copy from ``params`` under
their own name.  Every port tensor must be filled and every flax leaf
used, else :func:`load_flax` raises.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _convert(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == "copy":
        return arr
    if kind == "dense":
        return arr.T
    if kind == "conv":
        return arr.transpose(3, 2, 0, 1)
    if kind == "conv3d":
        return arr.transpose(4, 3, 0, 1, 2)
    if kind == "conv_transpose":
        return arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    raise ValueError(f"unknown conversion {kind!r}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(model: nn.Module, variables) -> dict:
    """Map a flax variables tree onto ``model``'s state_dict keys.

    variables: {"params": ..., "batch_stats": ...} of numpy-convertible
    arrays.  Returns {key: torch.Tensor} in the port's layout and dtype
    of the flax arrays."""
    leaves = {(coll,) + path: np.asarray(v)
              for coll in variables
              for path, v in _flatten(variables[coll])}
    used = set()
    out = {}
    for key, tensor in model.state_dict().items():
        mod_path, _, leaf = key.rpartition(".")
        module = model.get_submodule(mod_path) if mod_path else model
        spec = getattr(module, "flax_leaves", {}).get(leaf,
                                                      ("params", leaf, "copy"))
        coll, flax_leaf, kind = spec
        src = (coll, *(mod_path.split(".") if mod_path else ()), flax_leaf)
        if src not in leaves:
            raise KeyError(f"{key}: no flax leaf {'/'.join(src)}")
        arr = np.ascontiguousarray(_convert(leaves[src], kind))
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(f"{key}: flax {'/'.join(src)} gives "
                             f"{arr.shape}, port expects "
                             f"{tuple(tensor.shape)}")
        out[key] = torch.from_numpy(arr.copy())
        used.add(src)
    unused = sorted("/".join(k) for k in set(leaves) - used)
    if unused:
        raise KeyError(f"flax leaves with no port counterpart: {unused[:8]}"
                       + (" ..." if len(unused) > 8 else ""))
    return out


def load_flax(model: nn.Module, variables) -> nn.Module:
    """Load a flax variables tree into ``model`` in place (the model's
    tensors keep their dtype and device)."""
    sd = flax_to_state_dict(model, variables)
    model.load_state_dict(sd, strict=True)
    return model
