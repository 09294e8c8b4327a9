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
  names) splits each rank's ``HeteroDense`` weights, and the layers
  reduce over ``model`` themselves (``models/layers.py``);
* spatial parallelism (:func:`make_spatial_eval`): the per-agent maps'
  rows split over an axis, the fusion's local phases run K1's
  destination-row window and K2 on each shard
  (``models/hetero_fusion.py``).
"""
from __future__ import annotations

import os
import warnings

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


def tp_spec_for_path(path: str, shape, mp: int) -> tuple:
    """The partition spec of one leaf under the fusion-trunk TP layout, as
    a tuple (JAX's ``PartitionSpec``: None for a whole axis, "model" for a
    split one; () replicated).  ``path`` is a state-dict name (or a
    ``keystr``); anything not matched stays replicated."""
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


def tp_shard_tree(tree: dict, mesh: DeviceMesh) -> dict:
    """This rank's slice of every leaf of ``tree`` (a dict of tensors by
    state-dict name) under its TP spec (the whole leaf when no rule
    matches)."""
    mp, k = axis_size(mesh, "model"), axis_rank(mesh, "model")
    out = {}
    for name, x in tree.items():
        axis = _split_axis(tp_spec_for_path(name, tuple(x.shape), mp))
        out[name] = x if axis is None else x.chunk(mp, dim=axis)[k]
    return out


class TensorParallel:
    """A ``HeteroDense``'s role under TP: ``kind`` "col" (outputs split)
    or "row" (inputs split), over ``group`` of ``size`` ranks, this one
    ``rank``."""

    def __init__(self, kind: str, group, size: int, rank: int):
        self.kind, self.group, self.size, self.rank = kind, group, size, rank


def shard_state_tp(state, mesh: DeviceMesh):
    """Hybrid DP x TP placement of a train state: the state replicated
    from rank 0, then each fusion-trunk weight (and its AdamW moments)
    cut to this rank's slice over ``model`` by :func:`tp_spec_for_path`,
    and each split ``HeteroDense`` told its role; everything else
    replicated.  ``state.tp_axes`` records the split axis by name (the
    checkpoint gathers them back)."""
    from ..models.hetero_fusion import HeteroWindowAttention
    from ..models.layers import HeteroDense

    replicate_state(state, mesh)
    mp, k = axis_size(mesh, "model"), axis_rank(mesh, "model")
    group = axis_group(mesh, "model")
    model, axes = state.model, {}
    for name, p in model.named_parameters():
        axis = _split_axis(tp_spec_for_path(name, tuple(p.shape), mp))
        if axis is None:
            continue
        owner = model.get_submodule(name.rpartition(".")[0])
        if not isinstance(owner, HeteroDense):
            warnings.warn(f"TP: {name} matches a tensor-parallel rule but "
                          f"is not a HeteroDense weight; it stays "
                          f"replicated", stacklevel=2)
            continue
        if name.endswith(".kernel"):
            owner.tp = TensorParallel("col" if axis == p.ndim - 1 else "row",
                                      group, mp, k)
        axes[name] = axis
        with torch.no_grad():
            p.data = p.data.chunk(mp, dim=axis)[k].clone()
        for moment in state.opt.state.get(p, {}).values():
            if torch.is_tensor(moment) and moment.ndim == p.ndim:
                moment.data = moment.data.chunk(mp, dim=axis)[k].clone()
    for name, mod in model.named_modules():
        if isinstance(mod, HeteroWindowAttention) and mod.to_q.tp and \
                (mod.dim // mod.dim_head) % mp:
            raise ValueError(f"TP: {name} has {mod.dim // mod.dim_head} "
                             f"heads, which do not split over mp={mp}")
    state.tp_axes = axes
    return state


def audit_tp_sharding(model, mp: int):
    """Guard against silent fallback to replication (renamed modules no
    longer matching the rules).  INTENT comes from the structure, not from
    the rule names: every rank-3 ``HeteroDense`` kernel under the fusion
    trunk with an mp-divisible din or dout (of its whole shape) is meant
    to be split.  Returns (split names, silent misses)."""
    from ..models.layers import HeteroDense

    hit, miss = [], []
    for name, mod in model.named_modules():
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


def row_shard(mesh: DeviceMesh, axis: str = "model"):
    """The spatial split: (B, L, H, W, C) maps -> this rank's equal share
    of their rows over ``axis``."""
    nsh, k = axis_size(mesh, axis), axis_rank(mesh, axis)

    def shard(x):
        h = x.shape[2]
        if h % nsh:
            raise ValueError(f"SP: a map of {h} rows does not split into "
                             f"{nsh} equal shards")
        return x[:, :, k * (h // nsh):(k + 1) * (h // nsh)]

    return shard


def make_spatial_eval(model, mesh: DeviceMesh, axis: str = "model"):
    """Spatially partitioned batched inference (SP): ``fwd(batch)`` on this
    rank's data shard, with the per-agent BEV maps' rows (H) split evenly
    over ``axis`` (:func:`row_shard`).  The fusion's local phases run on
    each shard as the JAX package's island does (the senders' folded K/V
    gathered on H, K1's destination-row window, K2 on the shard's rows);
    a phase the island does not take gathers the map, runs as unsharded
    and keeps its rows, with the JAX package's warning.  The fused ego map
    is gathered before the decoder; outputs stay batch-sharded.  Weights
    replicated."""
    return _forward_under(model, lambda batch: model(batch, sp=(mesh, axis)))
