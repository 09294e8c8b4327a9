"""Learning-rate schedules and optimizers (port of
``hmvit_tpu/train/schedulers.py``).

A schedule is a plain function ``step -> learning rate`` with optax's
formulas (step, multistep, exponential, cosine annealing with linear
warm-up, constant), evaluated in float64 at the step count the
optimizer's update takes (the first update reads step 0).  The trainer
sets each parameter group's ``lr`` from it before every update.
``build_optimizer`` builds AdamW, Adam or SGD with optax's defaults over
the model's trainable parameters.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def _exponential(init_value, transition_steps, decay_rate, staircase=False):
    """optax ``exponential_decay`` (no transition_begin, no end_value)."""
    if transition_steps <= 0 or decay_rate == 0:
        return lambda step: float(init_value)

    def schedule(step):
        if step <= 0:
            return float(init_value)
        p = step / transition_steps
        if staircase:
            p = math.floor(p)
        return init_value * decay_rate ** p
    return schedule


def _piecewise_constant(init_value, boundaries_and_scales):
    """optax ``piecewise_constant_schedule``: the value is scaled by each
    boundary's factor once the step reaches it."""
    def schedule(step):
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if step >= threshold:
                v = v * scale
        return float(v)
    return schedule


def _warmup_cosine(init_value, peak_value, warmup_steps, decay_steps,
                   end_value=0.0):
    """optax ``warmup_cosine_decay_schedule`` (exponent 1): linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, "
                         f"got {decay_steps} and {warmup_steps}")

    def schedule(step):
        if step < warmup_steps:
            frac = 1 - min(max(step, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        count = min(step - warmup_steps, cosine_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / cosine_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)
    return schedule


def build_schedule(cfg: dict, base_lr: float,
                   steps_per_epoch: int) -> Callable[[int], float]:
    """``step -> lr`` from a hypes ``lr_scheduler`` block (its
    ``core_method`` matched case-insensitively, as the reference's
    loader does)."""
    method = str(cfg.get("core_method", "constant")).lower()
    if method == "step":
        return _exponential(base_lr, cfg["step_size"] * steps_per_epoch,
                            cfg.get("gamma", 0.1), staircase=True)
    if method == "multistep":
        return _piecewise_constant(base_lr, {
            int(e) * steps_per_epoch: cfg.get("gamma", 0.1)
            for e in cfg["step_size"]})
    if method == "exponential":
        return _exponential(base_lr, steps_per_epoch, cfg.get("gamma", 0.98))
    if method == "cosineannealwarm":
        warmup_steps = int(cfg.get("warmup_epoches", 0)) * steps_per_epoch
        total_steps = int(cfg["epoches"]) * steps_per_epoch
        return _warmup_cosine(float(cfg.get("warmup_lr", base_lr)), base_lr,
                              max(warmup_steps, 1),
                              max(total_steps, warmup_steps + 1),
                              float(cfg.get("lr_min", 0.0)))
    if method == "constant":
        return lambda step: float(base_lr)
    raise ValueError(f"unknown lr scheduler {method!r}")


def build_optimizer(model: torch.nn.Module, opt_cfg: dict, sched_cfg: dict,
                    steps_per_epoch: int, frozen_prefixes: tuple = ()):
    """(optimizer, schedule) from a hypes ``optimizer`` and
    ``lr_scheduler`` block: AdamW (betas 0.9 / 0.999, eps 1e-8, and the
    JAX package's ``build_optimizer`` default weight decay of 1e-2 unless
    the block names one: ``optax.adamw``'s own default is 1e-4), Adam or SGD
    (momentum 0.9).  Parameters of the top-level submodules in
    ``frozen_prefixes`` stay out of the optimizer: no update and no
    weight decay, as ``optax.set_to_zero`` gives them (staged training:
    a grafted backbone kept frozen)."""
    base_lr = float(opt_cfg["lr"])
    schedule = build_schedule(sched_cfg, base_lr, steps_per_epoch)
    name = opt_cfg.get("core_method", "AdamW").lower()
    args = opt_cfg.get("args", {})
    params = [p for name, p in model.named_parameters()
              if name.split(".", 1)[0] not in frozen_prefixes]
    if name == "adamw":
        opt = torch.optim.AdamW(
            params, lr=base_lr, eps=float(args.get("eps", 1e-8)),
            weight_decay=float(args.get("weight_decay", 1e-2)))
    elif name == "adam":
        opt = torch.optim.Adam(params, lr=base_lr,
                               eps=float(args.get("eps", 1e-8)))
    elif name == "sgd":
        opt = torch.optim.SGD(params, lr=base_lr,
                              momentum=float(args.get("momentum", 0.9)))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    return opt, schedule
