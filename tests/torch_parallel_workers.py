"""The ranks of ``tests/test_torch_parallel.py``: gloo processes on the
CPU (``torch.multiprocessing.spawn``), joined through a ``FileStore`` in
the test's own directory, each layout spawned once.  Rank 0 writes what
the test compares (``torch.save`` under ``out``); the test process holds
it against the single-process port and the JAX package.  No JAX here:
the ranks import torch, the port and the shared tiny configuration."""
from __future__ import annotations

import copy
import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from hmvit_tpu_torch import parallel
from hmvit_tpu_torch.parallel.collectives import gather_rows
from hmvit_tpu_torch.parallel.mesh import axis_group, full_state_dict
from hmvit_tpu_torch.data.synthetic import make_hetero_batch
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.train.checkpointing import save_checkpoint
from hmvit_tpu_torch.train.schedulers import build_optimizer
from hmvit_tpu_torch.train.trainer import (
    create_train_state,
    labels_for_batch,
    make_train_step,
)
from tiny_cfg import POSTPROCESS_CFG, RANGE, TINY_CFG

OPT_CFG = {"core_method": "AdamW", "lr": 2e-4,
           "args": {"eps": 1e-10, "weight_decay": 1e-2}}
SCHED_CFG = {"core_method": "cosineannealwarm", "epoches": 10,
             "warmup_lr": 2e-5, "warmup_epoches": 2, "lr_min": 5e-6}
SEED = 42

# test_spatial_eval_pallas_island's configuration: 256^2 pillars, fusion
# maps 64 x 64, shards of 32 rows over mp = 2
ISLAND_CFG = {
    "lidar": {
        "voxel_size": [0.16, 0.16, 4.0],
        "lidar_range": RANGE,
        "anchor_number": 2,
        "pillar_vfe": {"use_norm": True, "with_distance": False,
                       "use_absolute_xyz": True, "num_filters": [16]},
        "point_pillar_scatter": {"num_features": 16,
                                 "grid_size": [256, 256, 1]},
        "base_bev_backbone": {
            "layer_nums": [1, 1, 1], "layer_strides": [2, 2, 2],
            "num_filters": [16, 16, 16], "upsample_strides": [1, 2, 4],
            "num_upsample_filter": [16, 16, 16]},
        "shrink_header": {"kernal_size": [3], "stride": [2],
                          "padding": [1], "dim": [32], "input_dim": 48},
    },
    "camera": {"dim": 16, "bev_size": 16, "out_dim": 32, "num_blocks": 1,
               "decoder_layers": 2, "encoder_channels": (8, 16, 16, 16)},
    "compression": 0,
    "hetero_fusion": {
        "num_iters": 1,
        "hetero_fusion_block": {
            "spatial_transform": {"downsample_rate": 4,
                                  "voxel_size": [0.16, 0.16, 4]},
            "architect_mode": "sequential",
            "input_dim": 32, "mlp_dim": 32, "window_size": 8,
            "dim_head": 16, "drop_out": 0.0},
    },
    "hetero_decoder": {"input_dim": 32, "num_layer": 1,
                       "num_ch_dec": [32], "anchor_number": 2},
}


# the tiny configuration with dropout in the fusion (the attention's
# message and both FFN layers, the first on a column-split hidden under TP)
DROPOUT_CFG = copy.deepcopy(TINY_CFG)
DROPOUT_CFG["hetero_fusion"]["hetero_fusion_block"]["drop_out"] = 0.1

# the tiny configuration at 48 channels: 3 heads of 16, which do not split
# over mp = 2 (the channels, 24 a rank, do)
HEADS3_CFG = copy.deepcopy(TINY_CFG)
HEADS3_CFG["lidar"]["shrink_header"]["dim"] = [48]
HEADS3_CFG["camera"]["out_dim"] = 48
HEADS3_CFG["hetero_fusion"]["hetero_fusion_block"].update(input_dim=48,
                                                          mlp_dim=48)
HEADS3_CFG["hetero_decoder"].update(input_dim=48, num_ch_dec=[48])

# the tiny configuration with the FAX reference twin as camera encoder: its
# to_q / to_k / to_v are plain Dense layers (32 -> 2 heads of 8), whose
# flax kernels JAX's rules split by columns
FAX_REF_CFG = copy.deepcopy(TINY_CFG)
FAX_REF_CFG["camera"].update(encoder="fax_ref", heads=2, dim_head=8,
                             middle=[1, 1])

# the tiny configuration with V2X-ViT as the fusion: its HGT attention's
# typed to_q / to_k / to_v / to_out match JAX's rules
V2XVIT_CFG = dict(TINY_CFG, fusion_override="v2xvit")


def make_batch(batch_size, seed=0):
    """test_trainer_sharding.make_batch, as tensors."""
    batch, _ = make_hetero_batch(
        seed=seed, batch_size=batch_size, max_cav=2, num_agents=2,
        max_points=1024, image_size=32, camera_ratio=0.5, ego_mode="mixed",
        lidar_range=RANGE, num_cams=2)
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def setup(batch_size=8, cfg=TINY_CFG):
    """(model, opt, schedule, batch, labels) at seed 0."""
    batch = make_batch(batch_size)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    model = init_parameters(HMViT(cfg), 0)
    opt, schedule = build_optimizer(model, OPT_CFG, SCHED_CFG, 10)
    return model, opt, schedule, batch, labels


def train(state, step_fn, batch, labels, steps):
    losses = []
    for _ in range(steps):
        state, parts = step_fn(state, batch, labels, SEED)
        losses.append(float(parts["total_loss"]))
    return losses


def first_step(model):
    """The state dict after a step and the step's gradients (summed over
    the data axis under a mesh)."""
    return {"after": copy.deepcopy(model.state_dict()),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()}}


def single_reference(cfg=TINY_CFG):
    """The single-process port's first step from seed 0: its loss, the
    state dict after it and its gradients."""
    model, opt, schedule, batch, labels = setup(cfg=cfg)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, schedule=schedule)
    losses = train(state, step, batch, labels, 1)
    return {"losses": losses, **first_step(model)}


def _init(rank, world, store_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)


def _save(out, name, obj):
    if dist.get_rank() == 0:
        torch.save(obj, os.path.join(out, name + ".pt"))


def _dp_steps(mesh, out, name, steps, cfg=TINY_CFG):
    """Fresh state replicated over ``mesh``; ``steps`` steps of this
    rank's shard: losses, the state dict after the first step."""
    model, opt, schedule, batch, labels = setup(cfg=cfg)
    state = parallel.replicate_state(create_train_state(model, opt), mesh)
    step = make_train_step(model, opt, schedule=schedule)
    b, lab = parallel.shard_batch(batch, mesh), \
        parallel.shard_batch(labels, mesh)
    losses = train(state, step, b, lab, 1)
    first = first_step(model)
    losses += train(state, step, b, lab, steps - 1)
    _save(out, name, {"losses": losses, **first})


def layout_data(rank, world, store_dir, out):
    """World 2, a 1-D data mesh: the DP step (and 6 steps), the step with
    dropout, the sharded eval."""
    _init(rank, world, store_dir)
    mesh = parallel.make_mesh()
    _dp_steps(mesh, out, "dp2", 6)
    _dp_steps(mesh, out, "dp2_dropout", 1, DROPOUT_CFG)
    # sharded eval: 8 frames, 4 a rank
    model = init_parameters(HMViT(TINY_CFG), 0)
    batch = make_batch(8)
    fwd = parallel.make_sharded_eval(model, mesh)
    got = parallel.gather_batch(fwd(parallel.shard_batch(batch, mesh)),
                                mesh)
    _save(out, "sharded_eval", got)
    dist.destroy_process_group()


def _tp_step(mesh, out, name, cfg, steps):
    """A fresh DP x TP state over ``mesh``; ``steps`` steps of this rank's
    shard, warnings recorded: losses, the split leaves, the audit, and the
    state dict and gradients after the first step gathered to the single
    layout; then the eval forward of frame 0 (one a data rank) with and
    without its ``static_modes`` (the fusion's static [K|V] fold)."""
    model, opt, schedule, batch, labels = setup(cfg=cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state = parallel.shard_state_tp(create_train_state(model, opt), mesh)
        step = make_train_step(model, opt, schedule=schedule)
        b, lab = parallel.shard_batch(batch, mesh), \
            parallel.shard_batch(labels, mesh)
        losses = train(state, step, b, lab, 1)
        group = axis_group(mesh, "model")
        grads = {n: (gather_rows(p.grad, state.tp_axes[n], group)
                     if n in state.tp_axes else p.grad.clone())
                 for n, p in model.named_parameters()}
        after = {k: v.clone() for k, v in full_state_dict(state).items()}
        losses += train(state, step, b, lab, steps - 1)
    hit, miss = parallel.audit_tp_sharding(model, 2)
    frame = parallel.shard_batch({k: v[:1].repeat(2, *(1,) * (v.ndim - 1))
                                  for k, v in batch.items()}, mesh)
    static = tuple(int(m) for m in frame["mode"][0])
    model.eval()
    with torch.no_grad():
        folded = model(frame, static_modes=static)
        plain = model(frame)
    _save(out, name, {"losses": losses, "after": after, "grads": grads,
                      "tp_axes": dict(state.tp_axes), "hit": hit,
                      "miss": miss, "folded": folded, "plain": plain,
                      "warnings": sorted({str(w.message) for w in caught})})
    return state


def layout_hybrid(rank, world, store_dir, out):
    """World 4: the 4-rank DP step; a (2, 2) DP x TP mesh: 3 steps, the
    audit, the gathered checkpoint, a step with dropout, 2 steps at 3 heads
    and 2 steps with the FAX reference twin (its gathered checkpoint), a
    step with the V2X-ViT fusion; spatial eval over its model axis on the
    tiny and the island configurations."""
    _init(rank, world, store_dir)
    _dp_steps(parallel.make_mesh(), out, "dp4", 1)

    mesh = parallel.make_hybrid_mesh(mp=2)
    model, opt, schedule, batch, labels = setup(cfg=DROPOUT_CFG)
    state = parallel.shard_state_tp(create_train_state(model, opt), mesh)
    losses = train(state, make_train_step(model, opt, schedule=schedule),
                   parallel.shard_batch(batch, mesh),
                   parallel.shard_batch(labels, mesh), 1)
    _save(out, "hybrid_dropout", {"losses": losses})

    model, opt, schedule, batch, labels = setup()
    whole = {n: p.shape for n, p in model.named_parameters()}
    state = parallel.shard_state_tp(create_train_state(model, opt), mesh)
    split = len(state.tp_axes)
    hit, miss = parallel.audit_tp_sharding(model, 2)
    step = make_train_step(model, opt, schedule=schedule)
    losses = train(state, step, parallel.shard_batch(batch, mesh),
                   parallel.shard_batch(labels, mesh), 3)
    # the split leaves keep their slices through the steps
    still = sum(1 for n, p in model.named_parameters() if p.shape != whole[n])
    save_checkpoint(os.path.join(out, "ckpt"), 3, state)
    _save(out, "hybrid", {"losses": losses, "split": split, "still": still,
                          "hit": hit, "miss": miss})

    _tp_step(mesh, out, "heads3", HEADS3_CFG, 2)
    state = _tp_step(mesh, out, "fax_ref", FAX_REF_CFG, 2)
    save_checkpoint(os.path.join(out, "ckpt_fax_ref"), 2, state)

    _tp_step(mesh, out, "v2xvit_tp", V2XVIT_CFG, 1)

    for name, cfg, frames, seed in (("spatial_tiny", TINY_CFG, 8, 0),
                                    ("spatial_island", ISLAND_CFG, 4, 3)):
        model = init_parameters(HMViT(cfg), 4)
        batch = make_batch(frames, seed=seed)
        fwd = parallel.make_spatial_eval(model, mesh)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = fwd(parallel.shard_batch(batch, mesh))
        got = parallel.gather_batch(got, mesh)
        _save(out, name, {"out": got,
                          "warnings": sorted({str(w.message)
                                              for w in caught})})
    dist.destroy_process_group()


def layout_uneven(rank, world, store_dir, out):
    """World 3, a (1, 3) mesh: spatial eval of the tiny configuration over
    3 shards of its 16-row fusion map (6, 6 and 4 rows and 2 of padding)."""
    _init(rank, world, store_dir)
    mesh = parallel.make_hybrid_mesh(mp=3)
    model = init_parameters(HMViT(TINY_CFG), 4)
    fwd = parallel.make_spatial_eval(model, mesh)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = fwd(parallel.shard_batch(make_batch(8), mesh))
    _save(out, "spatial_uneven", {
        "out": parallel.gather_batch(got, mesh),
        "warnings": sorted({str(w.message) for w in caught})})
    dist.destroy_process_group()
