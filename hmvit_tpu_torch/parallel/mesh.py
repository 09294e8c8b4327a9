"""Device meshes for data, tensor and spatial parallelism (port of
``hmvit_tpu/parallel/mesh.py``).

One process a device, launched by ``torchrun`` (or anything that sets
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``):
:func:`init_from_env` joins the process group (NCCL on the card, gloo on
the CPU) and a ``DeviceMesh`` names its axes, ``("data",)`` or ``("data",
"model")``, process groups taken from it.  Where the JAX package lets
GSPMD insert the collectives, the port writes them out
(:mod:`.collectives`):

* data parallelism: each rank takes its slice of the batch
  (:func:`shard_batch`), train-mode batch statistics and the losses'
  normalisers span the data axis, and the train step sums the gradients
  over it;
* tensor parallelism: JAX's Megatron layout of the fusion trunk
  (:func:`tp_spec_for_path`, the same rules on the port's state-dict
  names, read in flax's layout) splits each rank's ``HeteroDense``
  weights, and the layers reduce over ``model`` themselves
  (``models/layers.py``); a plain ``Dense`` the rules match (the
  reference twins' ``to_q`` / ``to_k`` / ``to_v``) holds its columns and
  gathers its output (``nn.py``); an attention whose heads do not split
  over ``model`` gathers its projections to whole heads
  (``models/hetero_fusion.py``);
* spatial parallelism (:func:`make_spatial_eval`): the per-agent maps'
  rows split over an axis (padded with zero rows where they do not split
  evenly, as GSPMD pads), the fusion's local phases run K1's
  destination-row window and K2 on each shard
  (``models/hetero_fusion.py``).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def init_from_env(device=None) -> bool:
    """Join the process group that the launcher's environment describes
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL when
    ``device`` is a CUDA device, gloo otherwise.  True when a group exists
    (made here or before), False when the environment names none."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape=None, axis_names=("data",)) -> DeviceMesh:
    """1-D ``data`` mesh over the world by default; ``shape=(dp, mp)``
    with ``axis_names=("data", "model")`` for hybrid layouts."""
    shape = (dist.get_world_size(),) if shape is None else tuple(shape)
    return init_device_mesh(_device_type(), shape,
                            mesh_dim_names=tuple(axis_names))


def make_hybrid_mesh(mp: int = 1,
                     axis_names=("data", "model")) -> DeviceMesh:
    """(dp, mp) hybrid mesh: batch over ``data``, tensor-parallel fusion
    trunk over ``model``; dp = world // mp."""
    n = dist.get_world_size()
    if mp < 1 or n % mp:
        raise ValueError(f"{n} devices not divisible by mp={mp}")
    return make_mesh((n // mp, mp), axis_names)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(list(mesh.mesh_dim_names).index(axis))


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    return mesh.get_group(axis)


def _rank_rows(x, mesh, axis="data", dim=0):
    n, k = axis_size(mesh, axis), axis_rank(mesh, axis)
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"an axis of {size} does not split into {n} equal "
                         f"shards over {axis!r}")
    step = size // n
    index = (slice(None),) * dim + (slice(k * step, (k + 1) * step),)
    return x[index]


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's slice of every entry's leading axis over ``data`` (the
    batch must split into equal shards)."""
    return {k: _rank_rows(v, mesh) for k, v in batch.items()}


def gather_batch(tree: dict, mesh: DeviceMesh) -> dict:
    """The inverse of :func:`shard_batch` for a dict of tensors: every
    rank's shard, concatenated on the leading axis in ``data`` order."""
    from .collectives import gather_rows

    group = axis_group(mesh, "data")
    return {k: gather_rows(v, 0, group) for k, v in tree.items()}


def replicate_state(state, mesh: DeviceMesh):
    """Replicate the train state over the mesh: rank 0's parameters and
    statistics broadcast to every rank; the state then steps under the
    mesh (``state.mesh``)."""
    with torch.no_grad():
        for t in (*state.model.parameters(), *state.model.buffers()):
            dist.broadcast(t, src=0)
    state.mesh = mesh
    return state


# Megatron-style tensor-parallel layout for the H3GAT fusion trunk, the
# JAX package's rules: Q/K/V projections and FFN-up are COLUMN-parallel
# (output channels over 'model': each rank computes its own heads),
# to_out and FFN-down are ROW-parallel (input channels over 'model', one
# reduction per attention / FFN block).  Matched on the path, so the same
# rules split the parameters and the AdamW moments.
_TP_COL = ("to_q", "to_k", "to_v")
_TP_ROW = ("to_out",)
_TP_FFN = ("window_ffn", "grid_ffn", "mlp_head")


def _keystr(path: str) -> str:
    """A state-dict name in ``jax.tree_util.keystr``'s form
    (``a.b.c`` -> ``['a']['b']['c']``), which the rules read."""
    if path.startswith("["):
        return path
    return "".join(f"['{part}']" for part in path.split("."))


def tp_spec_for_path(path: str, shape, mp: int, kind: str) -> tuple:
    """The partition spec of one leaf under the fusion-trunk TP layout, as
    a tuple (JAX's ``PartitionSpec``: None for a whole axis, "model" for a
    split one; () replicated), on the port's axes.  ``path`` is a
    state-dict name (or a ``keystr``), ``shape`` the port's shape and
    ``kind`` the bridge's conversion of the leaf (its layer's
    ``flax_leaves``: a ``Dense`` weight is flax's kernel transposed):
    JAX's rules read the flax leaf's shape and their spec is carried back
    to the port's axes.  Anything not matched stays replicated."""
    from ..bridge import PORT_AXES

    if kind == "copy":
        return _flax_spec(path, tuple(shape), mp)
    axes = PORT_AXES[kind]
    flax_shape = [0] * len(shape)
    for i, a in enumerate(axes):
        flax_shape[a] = shape[i]
    spec = _flax_spec(path, tuple(flax_shape), mp)
    return tuple(spec[a] for a in axes) if spec else ()


def _flax_spec(path: str, shape, mp: int) -> tuple:
    """JAX's ``tp_spec_for_path`` on a flax leaf's shape."""
    path = _keystr(path)
    if "norm" in path or len(shape) < 2:
        return ()
    last_ok = shape[-1] % mp == 0
    mid_ok = len(shape) >= 2 and shape[-2] % mp == 0
    col = any(f"'{k}'" in path for k in _TP_COL)
    row = any(f"'{k}'" in path for k in _TP_ROW)
    if any(k in path for k in _TP_FFN):
        # HeteroDense_0 = up (column), HeteroDense_1 = down (row)
        col = col or "HeteroDense_0" in path
        row = row or "HeteroDense_1" in path
    if col and last_ok:
        # kernel (T, din, dout) / bias (T, dout): split the outputs
        return (None,) * (len(shape) - 1) + ("model",)
    if row and len(shape) >= 3 and mid_ok:
        # kernel (T, din, dout): split the inputs; bias stays replicated
        return (None,) * (len(shape) - 2) + ("model", None)
    return ()


def _split_axis(spec: tuple):
    return spec.index("model") if "model" in spec else None


def _leaf_kind(owner, leaf: str) -> str:
    """The bridge's conversion of ``owner``'s parameter ``leaf``."""
    return getattr(owner, "flax_leaves", {}).get(leaf, (None, None,
                                                        "copy"))[2]


def _owner(model, name: str):
    """The module holding state-dict entry ``name``, and the leaf's name."""
    mod, _, leaf = name.rpartition(".")
    return (model.get_submodule(mod) if mod else model), leaf


def tp_shard_tree(tree: dict, mesh: DeviceMesh, model) -> dict:
    """This rank's slice of every leaf of ``tree`` (a dict of tensors by
    ``model``'s state-dict names) under its TP spec (the whole leaf when
    no rule matches)."""
    mp, k = axis_size(mesh, "model"), axis_rank(mesh, "model")
    out = {}
    for name, x in tree.items():
        axis = _split_axis(tp_spec_for_path(
            name, tuple(x.shape), mp, _leaf_kind(*_owner(model, name))))
        out[name] = x if axis is None else x.chunk(mp, dim=axis)[k]
    return out


class TensorParallel:
    """A ``HeteroDense``'s or ``Dense``'s role under TP: ``kind`` "col"
    (outputs split) or "row" (inputs split), over ``group`` of ``size``
    ranks, this one ``rank``."""

    def __init__(self, kind: str, group, size: int, rank: int):
        self.kind, self.group, self.size, self.rank = kind, group, size, rank


def shard_state_tp(state, mesh: DeviceMesh):
    """Hybrid DP x TP placement of a train state: the state replicated
    from rank 0, then each weight JAX's rules split (the fusion trunk's
    ``HeteroDense``, a plain ``Dense`` named ``to_q`` / ``to_k`` /
    ``to_v``; and its AdamW moments) cut to this rank's slice over
    ``model`` by :func:`tp_spec_for_path`, and each split layer told its
    role; everything else replicated.  ``state.tp_axes`` records the
    split axis by name (the checkpoint gathers them back).  A matched leaf
    of any other layer raises: nothing that JAX splits stays quietly
    replicated."""
    from ..models.layers import HeteroDense
    from ..nn import Dense

    replicate_state(state, mesh)
    mp, k = axis_size(mesh, "model"), axis_rank(mesh, "model")
    group = axis_group(mesh, "model")
    model, axes = state.model, {}
    for name, p in model.named_parameters():
        owner, leaf = _owner(model, name)
        axis = _split_axis(tp_spec_for_path(name, tuple(p.shape), mp,
                                            _leaf_kind(owner, leaf)))
        if axis is None:
            continue
        if isinstance(owner, HeteroDense) and leaf == "kernel":
            owner.tp = TensorParallel("col" if axis == p.ndim - 1 else "row",
                                      group, mp, k)
        elif isinstance(owner, Dense) and leaf == "weight" and axis == 0:
            owner.tp = TensorParallel("col", group, mp, k)
        elif not isinstance(owner, HeteroDense):
            raise NotImplementedError(
                f"TP: {name} ({type(owner).__name__}) matches a "
                f"tensor-parallel rule on axis {axis}, which the port's "
                f"layer cannot split")
        axes[name] = axis
        with torch.no_grad():
            p.data = p.data.chunk(mp, dim=axis)[k].clone()
        for moment in state.opt.state.get(p, {}).values():
            if torch.is_tensor(moment) and moment.ndim == p.ndim:
                moment.data = moment.data.chunk(mp, dim=axis)[k].clone()
    state.tp_axes = axes
    return state


def audit_tp_sharding(model, mp: int):
    """Guard against silent fallback to replication (renamed modules no
    longer matching the rules).  INTENT comes from the structure, not from
    the rule names: every rank-3 ``HeteroDense`` kernel under the fusion
    trunk with an mp-divisible din or dout (of its whole shape) is meant
    to be split, and so is every plain ``Dense`` that the rules match
    (the reference twins' projections).  Returns (split names, silent
    misses)."""
    from ..models.layers import HeteroDense
    from ..nn import Dense

    hit, miss = [], []
    for name, mod in model.named_modules():
        if isinstance(mod, Dense):
            shape = list(mod.weight.shape)
            if mod.tp is not None:
                shape[0] *= mod.tp.size
            if "model" in tp_spec_for_path(f"{name}.weight", shape, mp,
                                           "dense"):
                (hit if mod.tp is not None else miss).append(
                    f"{name}.weight")
            continue
        if not isinstance(mod, HeteroDense) or "fusion" not in \
                name.split("."):
            continue
        shape = list(mod.kernel.shape)
        if mod.tp is not None:
            shape[-1 if mod.tp.kind == "col" else -2] *= mod.tp.size
        if shape[-1] % mp and shape[-2] % mp:
            continue  # indivisible: replication is the correct outcome
        (hit if mod.tp is not None else miss).append(f"{name}.kernel")
    return hit, miss


def full_state_dict(state) -> dict:
    """The model's state dict in the single-process layout: every TP
    slice gathered over ``model`` (a collective: every rank calls it)."""
    sd = state.model.state_dict()
    axes = getattr(state, "tp_axes", None) or {}
    if not axes:
        return sd
    from .collectives import gather_rows

    group = axis_group(state.mesh, "model")
    return {k: (gather_rows(v, axes[k], group) if k in axes else v)
            for k, v in sd.items()}


def full_optimizer_state(state) -> dict:
    """The optimizer's state dict in the single-process layout (the AdamW
    moments of TP slices gathered; a collective)."""
    sd = state.opt.state_dict()
    axes = getattr(state, "tp_axes", None) or {}
    if not axes:
        return sd
    from .collectives import gather_rows

    group = axis_group(state.mesh, "model")
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = [p for g in state.opt.param_groups for p in g["params"]]
    moments = {}
    for i, p in enumerate(params):
        axis = axes.get(names.get(id(p)))
        entry = sd["state"].get(i)
        if axis is None or entry is None:
            continue
        moments[i] = {k: (gather_rows(v, axis, group)
                          if torch.is_tensor(v) and v.ndim == p.ndim else v)
                      for k, v in entry.items()}
    return dict(sd, state={**sd["state"], **moments})


def _forward_under(model, fn):
    def fwd(batch):
        model.eval()
        with torch.no_grad():
            return fn(batch)
    return fwd


def make_sharded_eval(model, mesh: DeviceMesh):
    """Data-parallel batched inference: ``fwd(batch)`` runs this rank's
    shard of the batch (:func:`shard_batch`) through the model in eval
    mode (replicated weights, or a DP x TP model's own layout) and returns
    this rank's outputs; :func:`gather_batch` joins them."""
    return _forward_under(model, lambda batch: model(batch))


def shard_rows(h: int, nsh: int) -> int:
    """The rows of each of nsh shards of a map of h rows: ceil(h / nsh),
    the last shards padded as GSPMD pads an uneven split."""
    return -(-h // nsh)


def shard_of_rows(x, k: int, h_loc: int):
    """Shard k's rows [k h_loc, (k + 1) h_loc) of (B, L, H, ...) maps, the
    rows past H zeros."""
    part = x[:, :, k * h_loc:(k + 1) * h_loc]
    pad = h_loc - part.shape[2]
    if pad == 0:
        return part
    return torch.cat([part, part.new_zeros(*part.shape[:2], pad,
                                           *part.shape[3:])], dim=2)


def row_shard(mesh: DeviceMesh, axis: str = "model"):
    """The spatial split: (B, L, H, W, C) maps -> this rank's share of
    their rows over ``axis``, :func:`shard_rows` rows, the rows past H
    zeros."""
    nsh, k = axis_size(mesh, axis), axis_rank(mesh, axis)
    return lambda x: shard_of_rows(x, k, shard_rows(x.shape[2], nsh))


def make_spatial_eval(model, mesh: DeviceMesh, axis: str = "model"):
    """Spatially partitioned batched inference (SP): ``fwd(batch)`` on this
    rank's data shard, with the per-agent BEV maps' rows (H) split over
    ``axis`` (:func:`row_shard`; an uneven split pads with zero rows, which
    every consumer crops).  The fusion's local phases run on
    each shard as the JAX package's island does (the senders' folded K/V
    gathered on H, K1's destination-row window, K2 on the shard's rows);
    a phase the island does not take gathers the map, runs as unsharded
    and keeps its rows, with the JAX package's warning.  The fused ego map
    is gathered before the decoder; outputs stay batch-sharded.  Weights
    replicated."""
    return _forward_under(model, lambda batch: model(batch, sp=(mesh, axis)))
