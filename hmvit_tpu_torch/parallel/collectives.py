"""The collectives the model and the train step run under parallelism,
as autograd functions (the JAX package gets them from GSPMD; here they
are written out).

Four kinds, by what the backward must do:

* :func:`all_reduce_sum` over the ``data`` axis: forward and backward
  both sum, since every data rank's loss is a term of the global loss
  (train-mode BatchNorm statistics over the global batch);
* :func:`copy_to_model`: identity forward, sum of the gradients over
  ``model`` (the input of a column-parallel layer, and a replicated
  parameter each tensor-parallel rank uses a slice of);
* :func:`reduce_from_model`: sum forward, identity backward (the output
  of a row-parallel layer: downstream of it every ``model`` rank computes
  the same loss, so its gradient is already whole);
* :func:`gather_from_model`: the all-gather of every rank's slice
  forward, this rank's slice of the gradient backward (the output of a
  column-parallel layer gathered where the next operation needs whole
  rows: downstream of it every rank computes the same, so the gradient
  is whole on every rank); :func:`split_to_model` is its inverse, a
  replicated tensor cut to this rank's slice with its gradient summed
  (the input of a row-parallel layer).

:func:`data_parallel` installs the data group that BatchNorm and the
losses read (:func:`data_group`); the step sums the parameter
gradients over it after the backward.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_DATA_GROUP = contextvars.ContextVar("hmvit_tpu_torch_data_group",
                                     default=None)


@contextlib.contextmanager
def data_parallel(group):
    """Within the block, train-mode batch statistics and the losses'
    normalisers span the ranks of ``group`` (the mesh's ``data`` axis;
    None: this process's batch alone)."""
    token = _DATA_GROUP.set(group)
    try:
        yield group
    finally:
        _DATA_GROUP.reset(token)


def data_group():
    """The data group of :func:`data_parallel`, or None."""
    return _DATA_GROUP.get()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return gather_rows(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n, k = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[k].contiguous(), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x, group):
    """Sum over ``group``; the gradient is summed too."""
    return _AllReduceSum.apply(x, group)


def copy_to_model(x, group):
    """Identity; the gradient is summed over ``group``."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x, group):
    """Sum over ``group``; the gradient passes through."""
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x, dim: int, group):
    """Every rank's equal slice of ``x`` along ``dim`` joined in rank
    order; the gradient is cut back to this rank's slice."""
    return _GatherFromModel.apply(x, dim, group)


def split_to_model(x, dim: int, group):
    """This rank's equal slice of the replicated ``x`` along ``dim``; the
    gradient of ``x`` is summed over ``group`` (each rank's covers its
    own slice)."""
    n, k = dist.get_world_size(group), dist.get_rank(group)
    return copy_to_model(x, group).chunk(n, dim=dim)[k]


def global_sum(x):
    """``x`` summed over the data group of :func:`data_parallel` (``x``
    itself outside one), without a gradient: the losses' counts."""
    group = data_group()
    if group is None:
        return x
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


def global_batch(b: int) -> int:
    """The global batch of a step whose ranks each hold ``b`` rows (equal
    shards, as ``shard_batch`` cuts them)."""
    group = data_group()
    return b if group is None else b * dist.get_world_size(group)


def global_mean(x):
    """The mean of ``x`` over every rank's equal share of the data group of
    :func:`data_parallel` (each rank's term of the global mean; ``x.mean()``
    outside one)."""
    group = data_group()
    if group is None:
        return x.mean()
    return x.sum() / (x.numel() * dist.get_world_size(group))


def gather_rows(x, dim: int, group):
    """The all-gather of equal shards of ``x`` along ``dim`` over
    ``group``, in rank order (no gradient)."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
