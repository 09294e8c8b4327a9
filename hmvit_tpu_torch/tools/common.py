"""What the run-directory tools (``train``, ``inference``,
``performance``, ``sweep``) share: the device a tool runs on, the
synthetic mini-OPV2V it writes for ``--synthetic``, a collated numpy
batch moved to the device, and a run directory's model with its last
checkpoint."""
from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

# batch entries that stay on the host: object ids and the late-fusion
# sub-frame's transform to the ego
HOST_KEYS = ("object_ids", "to_ego")


def device_of(cpu: bool, tool: str) -> torch.device:
    """The CPU when ``cpu``, else the process's CUDA device: the launcher's
    ``LOCAL_RANK`` (``torchrun``), the first card without one (SystemExit
    without a card: the tools run on the card unless asked for the
    CPU)."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit(f"{tool}: no CUDA device (pass --cpu to run on the "
                         f"CPU)")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def write_synthetic(params: dict, prefix: str, max_points: int,
                    **layout) -> str:
    """Write a mini-OPV2V for the config's image size under a new
    temporary directory, point ``root_dir`` and ``validate_dir`` at it
    and return it; ``layout``: ``write_mini_opv2v``'s scenario, agent
    and frame counts."""
    from ..data.fixture import write_mini_opv2v

    root = tempfile.mkdtemp(prefix=prefix)
    cam_args = params["preprocess"]["args"]["camera_preprocess"]["args"]
    write_mini_opv2v(root, image_size=cam_args["resize_x"],
                     max_points=min(max_points, 8192), **layout)
    params["root_dir"] = params["validate_dir"] = root
    return root


def to_device(batch: dict, device) -> dict:
    """A collated numpy batch as tensors on ``device``, without the host
    entries."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in batch.items() if k not in HOST_KEYS}


def load_runnable(model_dir: str, device):
    """(model, config) of a run directory: the model its ``config.yaml``
    builds, in eval mode on ``device``, with the last checkpoint's
    weights; without a checkpoint it warns and keeps the weights drawn
    from seed 0."""
    from ..config import load_config
    from ..models.zoo import build_model
    from ..nn import init_parameters
    from ..train.checkpointing import saved_model_state

    params = load_config("", model_dir=model_dir)
    model = init_parameters(build_model(params["model"]), 0).to(device)
    saved = saved_model_state(os.path.join(os.path.abspath(model_dir),
                                           "ckpt"), map_location=device)
    if saved is None:
        print(f"WARNING: no checkpoint in {model_dir}, random weights")
    else:
        model.load_state_dict(saved)
    return model.eval(), params
