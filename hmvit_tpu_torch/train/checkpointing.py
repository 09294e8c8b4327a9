"""Checkpoints of a :class:`~hmvit_tpu_torch.train.trainer.TrainState`
(port of ``hmvit_tpu/train/checkpointing.py``, without orbax): one
directory per step holding ``torch.save`` of the model's and the
optimizer's state dicts and the step; resume finds the last step; a
pretrained encoder's state-dict entries can be grafted into a fusion
model's (staged training).  A state that steps under a mesh writes the
single-process layout: its tensor-parallel slices gathered, rank 0
writing."""
from __future__ import annotations

import os
import re

import torch

STATE_FILE = "state.pt"


def save_checkpoint(ckpt_dir: str, step: int, state) -> str:
    """Write ``state`` to ``ckpt_dir/<step>/``; returns that directory.
    Under a mesh every rank calls it (the tensor-parallel slices are
    gathered) and rank 0 writes."""
    path = os.path.join(ckpt_dir, str(int(step)))
    mesh = getattr(state, "mesh", None)
    if mesh is None:
        model_sd, opt_sd, writer = (state.model.state_dict(),
                                    state.opt.state_dict(), True)
    else:
        import torch.distributed as dist

        from ..parallel.mesh import full_optimizer_state, full_state_dict

        model_sd, opt_sd = full_state_dict(state), full_optimizer_state(state)
        writer = dist.get_rank() == 0
    if writer:
        os.makedirs(path, exist_ok=True)
        torch.save({"step": int(state.step), "model": model_sd,
                    "opt": opt_sd}, os.path.join(path, STATE_FILE))
    if mesh is not None:
        dist.barrier()
    return path


def find_last_step(ckpt_dir: str) -> int | None:
    """The largest step directory under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d) for d in os.listdir(ckpt_dir)
             if re.fullmatch(r"\d+", d)
             and os.path.isfile(os.path.join(ckpt_dir, d, STATE_FILE))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, state, step: int | None = None):
    """Load the checkpoint of ``step`` (default: the last) into
    ``state``'s model and optimizer, on their devices, and set its step;
    returns ``state``, or None when there is no checkpoint."""
    step = find_last_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    device = next(state.model.parameters()).device
    saved = torch.load(os.path.join(ckpt_dir, str(int(step)), STATE_FILE),
                       map_location=device, weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.opt.load_state_dict(saved["opt"])
    state.step = saved["step"]
    return state


def saved_model_state(ckpt_dir: str, step: int | None = None,
                      map_location="cpu") -> dict | None:
    """The model state dict of the checkpoint of ``step`` (default: the
    last), or None when there is no checkpoint."""
    step = find_last_step(ckpt_dir) if step is None else step
    if step is None:
        return None
    return torch.load(os.path.join(ckpt_dir, str(int(step)), STATE_FILE),
                      map_location=map_location, weights_only=True)["model"]


def graft_subtree(state_dict: dict, donor_state_dict: dict,
                  key: str) -> dict:
    """A copy of ``state_dict`` whose entries under the prefix ``key``
    (a top-level submodule, e.g. "camera_encoder") are the donor's:
    staged training loads a pretrained encoder into the fusion model."""
    prefix = key + "."
    mine = {k for k in state_dict if k.startswith(prefix)}
    theirs = {k for k in donor_state_dict if k.startswith(prefix)}
    if not mine or not theirs:
        raise KeyError(f"{key!r} missing from one of the state dicts")
    if mine != theirs:
        raise KeyError(f"{key!r}: the state dicts differ in entries "
                       f"{sorted(mine ^ theirs)[:8]}")
    out = dict(state_dict)
    out.update({k: donor_state_dict[k].clone() for k in theirs})
    return out
