"""The training step (port of ``hmvit_tpu/train/trainer.py``): a
:class:`TrainState`, the train step over the run-both trace or
bucketed on the batch's camera count, the eval step, the forward, and
the labels of a batch (anchor or anchor-free).

``half=True`` is the JAX package's ``_to_bf16``, not autocast: every
float32 parameter (BatchNorm and LayerNorm scales included) enters the
forward as a bfloat16 copy through ``torch.func.functional_call``, so
its gradient lands on the float32 master through the cast; every
float32 tensor of the batch (poses and intrinsics included) is cast;
the running statistics stay float32; the outputs are cast to float32
before the loss.  The optimizer updates the float32 masters.

Dropout draws from a generator seeded from (seed, step), the
counterpart of ``jax.random.fold_in(rng, state.step)``.

With the tracer on (:mod:`hmvit_tpu_torch.tracing`) a step opens three
spans: ``train.forward`` (the bf16 casts, the forward, the loss),
``train.backward`` and ``train.optimizer`` (the zero-filled gradients,
the data-parallel sum, the update).

A state that steps under a mesh (``parallel.replicate_state`` /
``shard_state_tp``) takes its rank's shard of the batch: the forward
and loss run under ``parallel.collectives.data_parallel`` (global
batch statistics and normalisers), the gradients are summed over the
``data`` axis, the reported loss is the global one, and every rank
draws from the one (seed, step) generator the whole tensor's dropout
mask, of which it keeps its block: the masks are the single process's.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import tracing
from ..nn import dropout_rng
from ..parallel.collectives import data_parallel
from .losses import point_pillar_loss


@dataclasses.dataclass
class TrainState:
    """The step count, the model (float32 master parameters and running
    statistics) and its optimizer; a train step updates all three in
    place.  ``mesh``: the device mesh the state steps under (None: this
    process alone); ``tp_axes``: the split axis of each tensor-parallel
    parameter by name."""
    step: int
    model: nn.Module
    opt: torch.optim.Optimizer
    mesh: object = None
    tp_axes: dict = dataclasses.field(default_factory=dict)


def create_train_state(model: nn.Module,
                       opt: torch.optim.Optimizer) -> TrainState:
    return TrainState(step=0, model=model, opt=opt)


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout generator of one step: seeded from (seed, step).  Every
    rank of a mesh draws from the same one: a mask is drawn over the
    whole tensor and each rank keeps its block (``nn.Dropout``)."""
    mixed = np.random.SeedSequence([int(seed), int(step)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(mixed))


def _data_axis(state):
    """The data group of a state that steps under a mesh, else None."""
    if state.mesh is None:
        return None
    from ..parallel.mesh import axis_group

    return axis_group(state.mesh, "data")


def _sum_over(tensors, group):
    """Sum ``tensors`` in place over ``group``, as one flat buffer."""
    from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

    flat = _flatten_dense_tensors(tensors)
    dist.all_reduce(flat, group=group)
    for t, v in zip(tensors, _unflatten_dense_tensors(flat, tensors)):
        t.copy_(v)


def _to_bf16(tensors: dict) -> dict:
    return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in tensors.items()}


def make_train_step(model, opt, loss_fn: Callable = point_pillar_loss,
                    loss_kwargs: dict | None = None, half: bool = False,
                    schedule: Callable[[int], float] | None = None):
    """Returns ``step(state, batch, labels, seed=0) -> (state, parts)``
    over the run-both trace (both encoders on every slot).  ``batch`` and
    ``labels`` are dicts of tensors on the model's device; ``parts`` are
    the loss's terms, detached.  ``schedule`` (``step -> lr``) sets every
    parameter group's learning rate before the update, as optax's
    schedule does inside its transformation; without it the groups keep
    theirs.  ``half=True``: bfloat16 compute against float32 masters (see
    the module's docstring)."""
    return _make_train_step(model, opt, loss_fn, loss_kwargs, half,
                            schedule, camera_bucket=None)


def _make_train_step(model, opt, loss_fn, loss_kwargs, half, schedule,
                     camera_bucket=None):
    loss_kwargs = loss_kwargs or {}
    apply_kwargs = ({} if camera_bucket is None
                    else {"camera_bucket": camera_bucket})
    # the optimizer's parameters: each gets a gradient every step (zero
    # for a branch the step did not run, as in the JAX package, so
    # AdamW still decays it)
    trained = [p for group in opt.param_groups for p in group["params"]]

    def step(state: TrainState, batch: dict, labels: dict, seed: int = 0):
        if state.model is not model or state.opt is not opt:
            raise ValueError("the state holds another model or optimizer "
                             "than this step was made for")
        device = next(model.parameters()).device
        model.train()
        model.zero_grad(set_to_none=True)
        group = _data_axis(state)
        with dropout_rng(step_generator(seed, state.step, device)), \
                data_parallel(group):
            with tracing.span("train.forward"):
                batch_in = _to_bf16(batch) if half else batch
                if half:
                    params = _to_bf16(dict(model.named_parameters()))
                    out = torch.func.functional_call(model, params,
                                                     (batch_in,),
                                                     apply_kwargs)
                    out = {k: v.to(torch.float32) for k, v in out.items()}
                else:
                    out = model(batch_in, **apply_kwargs)
                total, parts = loss_fn(out, labels, **loss_kwargs)
            with tracing.span("train.backward"):
                total.backward()
        with tracing.span("train.optimizer"):
            for p in trained:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            parts = {k: v.detach() for k, v in parts.items()}
            if group is not None:
                _sum_over([p.grad for p in trained], group)
                _sum_over(list(parts.values()), group)
            if schedule is not None:
                lr = schedule(state.step)
                for group in opt.param_groups:
                    group["lr"] = lr
            opt.step()
        state.step += 1
        return state, parts

    return step


def make_bucketed_train_step(model, opt, loss_fn: Callable = point_pillar_loss,
                             loss_kwargs: dict | None = None,
                             half: bool = False,
                             schedule: Callable[[int], float] | None = None):
    """The train step specialised on the batch's camera count: the camera
    encoder's forward, backward and remat recompute run on the camera
    rows only, the lidar encoder's on the rest (the model's
    ``camera_bucket``).  Each branch's train-mode BatchNorm normalises
    over its real rows (the reference's row split); a branch the batch
    does not run gets zero gradients, which AdamW still decays (the
    reference's ``find_unused_parameters`` contract).  One step function
    per camera count is kept (``cache_info``), as the JAX package keeps
    one compiled step."""
    @functools.lru_cache(maxsize=None)
    def bucket(n_cam: int):
        return _make_train_step(model, opt, loss_fn, loss_kwargs, half,
                                schedule, camera_bucket=n_cam)

    def dispatch(state, batch, labels, seed: int = 0):
        group = _data_axis(state)
        if state.tp_axes or (group is not None
                             and dist.get_world_size(group) > 1):
            raise ValueError("the bucketed step is a single-card "
                             "specialization: each rank would pick its own "
                             "camera count; step under dp / mp with "
                             "make_train_step")
        # the active camera agents: one host read of mode and agent_mask
        mode = torch.as_tensor(batch["mode"]).cpu()
        active = torch.as_tensor(batch["agent_mask"]).cpu() > 0
        n_cam = int(((mode == 0) & active).sum())
        return bucket(n_cam)(state, batch, labels, seed)

    dispatch.cache_info = bucket.cache_info
    return dispatch


def make_eval_step(model, loss_fn: Callable = point_pillar_loss,
                   loss_kwargs: dict | None = None):
    """``step(state, batch, labels) -> parts`` in eval mode (running
    statistics, no dropout), without gradients."""
    loss_kwargs = loss_kwargs or {}

    def step(state: TrainState, batch: dict, labels: dict):
        state.model.eval()
        with torch.no_grad():
            out = state.model(batch)
            _, parts = loss_fn(out, labels, **loss_kwargs)
        return parts

    return step


def make_forward(model):
    """``forward(state, batch) -> outputs`` in eval mode, no gradients."""
    def fwd(state: TrainState, batch: dict):
        state.model.eval()
        with torch.no_grad():
            return state.model(batch)

    return fwd


def labels_for_batch(postprocessor, anchors, batch, device=None) -> dict:
    """Host-side labels of a padded batch (numpy arrays or tensors), as
    float32 tensors on ``device``: the anchor labels ``pos_equal_one``,
    ``neg_equal_one`` (B, H, W, A) and ``targets`` (B, H, W, 7A); or,
    without anchors (``anchors is None``: the BEV postprocessor of the
    PIXOR family), the stacked anchor-free ``label_map`` (B, 7, H, W)."""
    centers = np.asarray(torch.as_tensor(batch["object_bbx_center"]).cpu())
    masks = np.asarray(torch.as_tensor(batch["object_bbx_mask"]).cpu())
    if anchors is None:
        maps = [postprocessor.generate_label(gt_box_center=centers[i],
                                             mask=masks[i])["label_map"]
                for i in range(centers.shape[0])]
        return {"label_map": torch.as_tensor(np.stack(maps),
                                             dtype=torch.float32,
                                             device=device)}
    labels = [postprocessor.generate_label(centers[i], anchors, masks[i])
              for i in range(centers.shape[0])]
    return {key: torch.as_tensor(np.stack([lab[key] for lab in labels]),
                                 dtype=torch.float32, device=device)
            for key in ("pos_equal_one", "neg_equal_one", "targets")}
