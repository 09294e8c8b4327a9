"""YAML model configurations ("hypes") with a registry of the parsers
that derive parameters from them (port of ``hmvit_tpu/config/
loader.py``, without PyYAML).

A hypes file names its own post-processors in a top-level
``yaml_parser`` key (a string or a list); a run directory's
``config.yaml`` snapshot, when present, takes the place of the file, so
that a run resumes and evaluates with the configuration it trained
with.  The file is read by the port's YAML reader in its hypes mode
(:func:`hmvit_tpu_torch.data.codecs.yaml_load`: anchors and aliases,
and PyYAML's YAML 1.1 resolver with the JAX loader's float pattern, so
``2e-4`` is a float); an alias is the anchored object itself, as in
PyYAML, so a parser's write to it shows wherever it is referred to.
The snapshot is written by the port's YAML writer; both packages'
loaders read it back equal.
"""
from __future__ import annotations

import math
import os
from typing import Callable

import numpy as np

from ..data.codecs import yaml_dump, yaml_load_file

_PARSERS: dict[str, Callable[[dict], dict]] = {}


def register_parser(fn: Callable[[dict], dict]):
    _PARSERS[fn.__name__] = fn
    return fn


def load_config(path: str, model_dir: str | None = None) -> dict:
    """Load a hypes YAML; if ``model_dir`` is given, its config snapshot
    wins."""
    if model_dir:
        snap = os.path.join(model_dir, "config.yaml")
        if os.path.exists(snap):
            path = snap
    params = yaml_load_file(path, hypes=True)
    params["fileDirname"] = os.path.dirname(os.path.abspath(path))

    parsers = params.get("yaml_parser")
    if parsers:
        if isinstance(parsers, str):
            parsers = [parsers]
        for name in parsers:
            if name not in _PARSERS:
                raise KeyError(
                    f"unknown yaml_parser {name!r}; known: {sorted(_PARSERS)}"
                )
            params = _PARSERS[name](params)
    return params


def save_config(params: dict, path: str) -> None:
    out = {k: v for k, v in params.items() if k != "fileDirname"}
    with open(path, "w") as f:
        f.write(yaml_dump(_plain(out)))


def _plain(obj):
    """Recursively convert tuples and numpy scalars / arrays to what the
    YAML writer takes."""
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _lidar_voxel_size(params: dict):
    args = params["preprocess"]["args"]
    if "voxel_size" in args:
        return args["voxel_size"]
    return args["lidar_preprocess"]["args"]["voxel_size"]


def _fill_anchor_grid(params: dict) -> dict:
    """Derive the anchor grid's extents W / H / D and voxel sizes from the
    lidar range."""
    rng = params["preprocess"]["cav_lidar_range"]
    vw, vh, vd = _lidar_voxel_size(params)
    anchor_args = params["postprocess"]["anchor_args"]
    anchor_args.update(
        vw=vw,
        vh=vh,
        vd=vd,
        W=math.ceil((rng[3] - rng[0]) / vw),
        H=math.ceil((rng[4] - rng[1]) / vh),
        D=math.ceil((rng[5] - rng[2]) / vd),
    )
    return params


def _grid_size(params: dict) -> list[int]:
    rng = np.array(params["preprocess"]["cav_lidar_range"])
    voxel = np.array(_lidar_voxel_size(params))
    return np.round((rng[3:6] - rng[0:3]) / voxel).astype(int).tolist()


@register_parser
def load_point_pillar_params(params: dict) -> dict:
    grid = _grid_size(params)
    margs = params["model"]["args"]
    margs.setdefault("point_pillar_scatter", {})["grid_size"] = grid
    if "lidar" in margs and "point_pillar_scatter" in margs["lidar"]:
        margs["lidar"]["point_pillar_scatter"]["grid_size"] = grid
    return _fill_anchor_grid(params)


@register_parser
def load_camera_point_pillar_params(params: dict) -> dict:
    grid = _grid_size(params)
    margs = params["model"]["args"]
    margs.setdefault("point_pillar_scatter", {})["grid_size"] = grid
    for branch in ("camera", "lidar"):
        if branch in margs and "point_pillar_scatter" in margs[branch]:
            margs[branch]["point_pillar_scatter"]["grid_size"] = grid
    return _fill_anchor_grid(params)


@register_parser
def load_voxel_params(params: dict) -> dict:
    params = _fill_anchor_grid(params)
    a = params["postprocess"]["anchor_args"]
    if "model" in params:
        params["model"]["args"].update(W=a["W"], H=a["H"], D=a["D"])
    return params


@register_parser
def load_bev_params(params: dict) -> dict:
    """BEV geometry of the anchor-free PIXOR family: the whole
    ``geometry_param`` dict, put into the preprocess, postprocess and
    model args (input z-channels: nz occupancy slices + 1 intensity)."""
    res = float(params["preprocess"]["args"]["res"])
    downsample = int(params["preprocess"]["args"]["downsample_rate"])
    rng = params["preprocess"]["cav_lidar_range"]
    l1, w1, h1, l2, w2, h2 = [float(v) for v in rng]
    nx, ny, nz = (int((l2 - l1) / res), int((w2 - w1) / res),
                  int((h2 - h1) / res))
    geometry = {
        "L1": l1, "L2": l2, "W1": w1, "W2": w2, "H1": h1, "H2": h2,
        "res": res, "downsample_rate": downsample,
        "input_shape": (nx, ny, nz + 1),
        "label_shape": (nx // downsample, ny // downsample, 7),
    }
    params["preprocess"]["geometry_param"] = geometry
    params["postprocess"]["geometry_param"] = geometry
    if "model" in params:
        params["model"]["args"]["geometry_param"] = geometry
    params["postprocess"]["anchor_args"] = params["postprocess"].get(
        "anchor_args", {}
    )
    params["postprocess"]["anchor_args"]["cav_lidar_range"] = rng
    return params


@register_parser
def load_camera_params(params: dict) -> dict:
    """Camera-only families: the anchors are still derived for the
    detection evaluation."""
    return _fill_anchor_grid(params)
