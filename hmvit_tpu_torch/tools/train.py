"""Training CLI (port of ``hmvit_tpu/tools/train.py``).

A hypes YAML and a run directory: the configuration is snapshot into
``<model_dir>/config.yaml`` (which wins over ``--hypes_yaml`` when the
directory already has one), training resumes from the directory's last
checkpoint, the modalities are re-drawn every epoch, the validation
loss is read every ``eval_freq`` epochs and a checkpoint written every
``save_freq`` epochs (``ckpt/<epoch + 1>/``).  Pretrained single-modality
encoders can be grafted in (``--camera_backbone_dir``,
``--lidar_backbone_dir``) and kept frozen (``--fix_*_backbone``).  The
host loads the next batch on a thread (its frames decoded by a pool of
``--num_workers``) while the card runs the current step.

    python -m hmvit_tpu_torch.tools.train --hypes_yaml <cfg.yaml>
        [--model_dir d] [--synthetic] [--epoches N] [--steps_per_epoch N]
        [--max_points P] [--batch_size B] [--half] [--remat] [--bucketed]
        [--mp N] [--cpu]

Launched by ``torchrun --nproc_per_node N -m hmvit_tpu_torch.tools.train
...`` (or under any process group already made), one process a card (the
CPU with ``--cpu``, over gloo): data parallelism spans the world, and
``--mp N`` makes it a (world / N, N) mesh whose ``model`` axis splits the
fusion trunk (``hmvit_tpu_torch/parallel``).  Every rank reads the same
batches and takes its shard; rank 0 writes the metrics, the
configuration and the checkpoints (tensor-parallel slices gathered: the
single-process layout).

The flags are the JAX tool's, plus ``--cpu`` (run on the CPU, where every
kernel wrapper runs its plain twin; without it the tool runs on the
card).  A segmentation config (loss ``vanilla_seg_loss`` / ``seg_loss``)
trains its BEV heads on the map ground truth (``dataset.seg_labels`` at
the heads' grid, read from one eval forward) with ``seg_loss``'s class
weights ``d_weights`` / ``s_weights``; an anchor-free one (PIXOR) on its
label map.  Differences: the
scalars go to ``metrics.jsonl`` every
10 steps, not to TensorBoard; the dataset's draws come from ``--seed``
(the JAX dataset draws fresh entropy); and a resume restores the
optimizer's state and step with the weights (the JAX tool restores the
weights alone).
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

# a frame's entries that seg_labels reads
SEG_FRAME_KEYS = ("object_bbx_center", "object_bbx_mask", "gt_dynamic",
                  "gt_static", "has_map_gt")

def parse_args(argv=None):
    p = argparse.ArgumentParser("hmvit_tpu_torch trainer")
    p.add_argument("--hypes_yaml", required=True)
    p.add_argument("--model_dir", default="")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a mini on-disk OPV2V instead of reading "
                        "root_dir (for smoke runs without the dataset)")
    p.add_argument("--epoches", type=int, default=0)
    p.add_argument("--steps_per_epoch", type=int, default=0)
    p.add_argument("--max_points", type=int, default=60000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=0,
                   help="override train_params.batch_size")
    p.add_argument("--mp", type=int, default=1,
                   help="tensor-parallel degree: the processes form a "
                        "(world / mp, mp) mesh, the fusion trunk split over "
                        "mp (parallel/mesh.py shard_state_tp)")
    p.add_argument("--num_workers", type=int, default=4,
                   help="threads decoding a batch's frames")
    p.add_argument("--bucketed", action="store_true",
                   help="train step specialised on the batch's camera "
                        "count: each encoder runs on its own rows only")
    p.add_argument("--half", action="store_true",
                   help="bf16 compute (fp32 master params)")
    p.add_argument("--remat", action="store_true",
                   help="gradient checkpointing of the camera, lidar and "
                        "fusion stages")
    p.add_argument("--camera_backbone_dir", default="")
    p.add_argument("--lidar_backbone_dir", default="")
    p.add_argument("--fix_camera_backbone", action="store_true")
    p.add_argument("--fix_lidar_backbone", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain twins)")
    return p.parse_args(argv)


def graft_backbone(model, key: str, donor_dir: str) -> bool:
    """Load the ``key`` submodule's weights from ``donor_dir``'s last
    checkpoint into ``model``; False when the donor has no checkpoint."""
    from ..train.checkpointing import graft_subtree, saved_model_state

    donor = saved_model_state(os.path.join(donor_dir, "ckpt"))
    if donor is None:
        return False
    model.load_state_dict(graft_subtree(model.state_dict(), donor, key))
    return True


def main(argv=None, on_step=None):
    """Train; returns the run directory.  ``on_step(epoch, step,
    metrics)``, when given, is called after every train step."""
    args = parse_args(argv)

    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from ..config import load_config, save_config
    from ..data.opv2v import HeteroCooperativeDataset
    from ..models.zoo import build_model
    from ..nn import init_parameters
    from ..parallel import (init_from_env, make_hybrid_mesh, make_mesh,
                            replicate_state, shard_batch, shard_state_tp)
    from ..parallel.mesh import axis_size
    from ..postprocess import build_postprocessor
    from ..train.checkpointing import find_last_step, restore_checkpoint, \
        save_checkpoint
    from ..train.losses import SEG_LOSSES, build_loss
    from ..train.schedulers import build_optimizer
    from ..train.trainer import create_train_state, labels_for_batch, \
        make_bucketed_train_step, make_eval_step, make_train_step
    from .common import device_of, to_device, write_synthetic

    dev = device_of(args.cpu, "tools.train")
    joined = not dist.is_initialized() and init_from_env(dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    lead = not dist.is_initialized() or dist.get_rank() == 0
    mp = max(1, args.mp)
    if world % mp:
        raise SystemExit(
            f"--mp {mp}: the fusion trunk splits over mp processes, and "
            f"{world} do not divide by it; launch a multiple of {mp} with "
            f"`torchrun --nproc_per_node {mp} -m hmvit_tpu_torch.tools.train "
            f"...`")
    params = load_config(args.hypes_yaml, model_dir=args.model_dir or None)
    if args.epoches:
        params["train_params"]["epoches"] = args.epoches
        params["lr_scheduler"]["epoches"] = args.epoches
    if args.synthetic:
        write_synthetic(params, "mini_opv2v_", args.max_points,
                        num_scenarios=2, num_cavs=2, num_frames=4)

    run_dir = args.model_dir or os.path.join(
        "runs", f"{params['name']}_{time.strftime('%Y%m%d_%H%M%S')}")
    os.makedirs(run_dir, exist_ok=True)
    if lead:
        save_config(params, os.path.join(run_dir, "config.yaml"))

    dataset = HeteroCooperativeDataset(params, train=True,
                                       max_points=args.max_points,
                                       seed=args.seed)
    val_dataset = HeteroCooperativeDataset(params, train=False,
                                           max_points=args.max_points)
    pp = build_postprocessor(params["postprocess"], train=True)
    anchors = pp.generate_anchor_box()

    if args.remat:
        params["model"].setdefault("args", {})["remat"] = True
    model = init_parameters(build_model(params["model"]), args.seed)
    batch_size = args.batch_size or params["train_params"]["batch_size"]
    steps_per_epoch = args.steps_per_epoch or max(
        len(dataset) // batch_size, 1)

    # staged training: graft pretrained single-modality encoders
    for key, donor_dir in (("camera_encoder", args.camera_backbone_dir),
                           ("lidar_encoder", args.lidar_backbone_dir)):
        if donor_dir and graft_backbone(model, key, donor_dir):
            print(f"grafted {key} from {donor_dir}")
    model = model.to(dev)
    frozen = ()
    if args.fix_camera_backbone:
        frozen += ("camera_encoder",)
    if args.fix_lidar_backbone:
        frozen += ("lidar_encoder",)
    opt, schedule = build_optimizer(model, params["optimizer"],
                                    params["lr_scheduler"], steps_per_epoch,
                                    frozen)
    state = create_train_state(model, opt)

    ckpt_dir = os.path.join(os.path.abspath(run_dir), "ckpt")
    last = find_last_step(ckpt_dir)
    start_epoch = 0
    if last is not None:
        restore_checkpoint(ckpt_dir, state, last)
        start_epoch = last
        print(f"resumed from epoch {last}")
    mesh = None
    if dist.is_initialized():
        # batch over 'data', the fusion trunk over 'model' with --mp
        mesh = make_hybrid_mesh(mp) if mp > 1 else make_mesh()
        state = (shard_state_tp if mp > 1 else replicate_state)(state, mesh)
        dp = axis_size(mesh, "data")
        if batch_size % dp:
            raise SystemExit(
                f"batch_size {batch_size} must be a multiple of the "
                f"data-parallel degree {dp} (processes {world} / mp {mp}); "
                "pass --batch_size or adjust train_params.batch_size")
        if args.bucketed and (dp > 1 or mp > 1):
            raise SystemExit("--bucketed is a single-card step "
                             "specialization; drop it under dp/mp sharding")

    loss_fn, loss_kwargs = build_loss(params.get("loss", {}))
    seg_task = params.get("loss", {}).get("core_method", "") in SEG_LOSSES
    make_step = make_bucketed_train_step if args.bucketed else make_train_step
    train_step = make_step(model, opt, loss_fn=loss_fn,
                           loss_kwargs=loss_kwargs, half=args.half,
                           schedule=schedule)
    eval_step = make_eval_step(model, loss_fn=loss_fn,
                               loss_kwargs=loss_kwargs)

    epoches = params["train_params"]["epoches"]
    eval_freq = params["train_params"].get("eval_freq", 2)
    save_freq = params["train_params"].get("save_freq", 1)

    seg_grid = None
    if seg_task:
        # the heads' grid, from one eval forward
        example = to_device(dataset.collate_batch([dataset[0]]), dev)
        model.eval()
        with torch.no_grad():
            out0 = model(example)
        key0 = "dynamic_seg" if "dynamic_seg" in out0 else "static_seg"
        if key0 not in out0:
            raise ValueError(
                f"loss {params['loss']['core_method']!r} trains the BEV "
                f"segmentation heads, but model "
                f"{params['model']['core_method']!r} outputs {sorted(out0)}")
        seg_grid = tuple(int(v) for v in out0[key0].shape[1:3])
        del example, out0

    def make_labels(batch, device=None):
        if not seg_task:
            return labels_for_batch(pp, anchors, batch, device)
        per_frame = [dataset.seg_labels(
            {k: batch[k][i] for k in SEG_FRAME_KEYS if k in batch},
            seg_grid) for i in range(batch["object_bbx_center"].shape[0])]
        return {k: torch.as_tensor(np.stack([f[k] for f in per_frame]),
                                   dtype=torch.int32, device=device)
                for k in per_frame[0]}

    def make_batch(idxs):
        """Host work of a batch (decode, collate, labels), on the
        prefetch thread; the copies to the card stay on the main one."""
        if frame_pool is not None:
            frames = list(frame_pool.map(lambda i: dataset[int(i)], idxs))
        else:
            frames = [dataset[int(i)] for i in idxs]
        while len(frames) < batch_size:
            frames.append(frames[-1])
        batch = dataset.collate_batch(frames)
        return batch, make_labels(batch)

    # one batch ahead on a thread, its frames decoded by a pool
    prefetcher = ThreadPoolExecutor(max_workers=1)
    frame_pool = (ThreadPoolExecutor(max_workers=args.num_workers)
                  if args.num_workers > 1 else None)

    order = np.arange(len(dataset))
    host_rng = np.random.default_rng(args.seed)
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    with open(metrics_path, "a") as mf:
        for epoch in range(start_epoch, epoches):
            host_rng.shuffle(order)
            t_ep = time.time()

            def idxs_for(step):
                return order[(step * batch_size) % len(order):][:batch_size]

            pending = prefetcher.submit(make_batch, idxs_for(0))
            for step in range(steps_per_epoch):
                batch, labels = pending.result()
                if step + 1 < steps_per_epoch:
                    pending = prefetcher.submit(make_batch,
                                                idxs_for(step + 1))
                batch = to_device(batch, dev)
                labels = {k: v.to(dev) for k, v in labels.items()}
                if mesh is not None:
                    batch = shard_batch(batch, mesh)
                    labels = shard_batch(labels, mesh)
                state, metrics = train_step(state, batch, labels,
                                            args.seed + 1)
                if on_step is not None:
                    on_step(epoch, step, metrics)
                if step % 10 == 0 and lead:
                    rec = {"epoch": epoch, "step": step,
                           "lr": float(schedule(state.step)),
                           **{k: float(v) for k, v in metrics.items()}}
                    mf.write(json.dumps(rec) + "\n")
                    mf.flush()
                    extras = " ".join(
                        f"{k}={v:.4f}" for k, v in rec.items()
                        if k not in ("epoch", "step", "lr", "total_loss"))
                    print(f"[epoch {epoch}][{step}/{steps_per_epoch}] "
                          f"loss={rec['total_loss']:.4f} {extras}",
                          flush=True)

            if epoch % eval_freq == 0:
                val_losses = []
                for vi in range(min(len(val_dataset), 4)):
                    vb = val_dataset.collate_batch([val_dataset[vi]]
                                                   * batch_size)
                    vl = make_labels(vb, dev)
                    m = eval_step(state, to_device(vb, dev), vl)
                    val_losses.append(float(m["total_loss"]))
                if lead:
                    print(f"[epoch {epoch}] val_loss="
                          f"{np.mean(val_losses):.4f} "
                          f"({time.time() - t_ep:.1f}s/epoch)", flush=True)

            if epoch % save_freq == 0:
                save_checkpoint(ckpt_dir, epoch + 1, state)

            dataset.reinitialize()
    prefetcher.shutdown()
    if frame_pool is not None:
        frame_pool.shutdown()
    if joined:
        dist.destroy_process_group()
    if lead:
        print(f"training done -> {run_dir}")
    return run_dir


if __name__ == "__main__":
    main()
