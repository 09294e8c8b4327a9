"""The accuracy gate at production shapes (the port of ``prod_overfit.py``):
overfit the flagship HMViT on the on-disk mini-OPV2V fixture through the
whole path (pcd / png / yaml loader -> collate -> anchor labels -> bf16
train step with remat -> eval forward -> anchor decode -> rotated NMS ->
VOC AP) until the watched AP reaches the target.  A scale-dependent fault
(bf16 loss numerics, the remat boundary, the 100-box padding) fails here
and in no unit test.

    python -m hmvit_tpu_torch.prod_overfit [--max_steps N] [--lr LR]
        [--eval_every N] [--target_metric ap50|ap70] [--target T]
        [--grid 512] [--fp32] [--cpu] [--seed S] [--log PATH]

The flags are the JAX script's, plus ``--cpu`` (run on the CPU, where
every kernel wrapper runs its plain twin; a rehearsal at a shrunk
``--grid``) and ``--seed`` (the weights and the dataset's draws; the
fixture keeps the JAX script's scene).  ``--grid`` scales every spatial
size of the production configuration; 512 is production.  The optimizer
is ``optax.adamw(lr)``'s: AdamW with betas (0.9, 0.999), eps 1e-8 and
weight decay 1e-4.  Each evaluation appends a line to ``--log``
(relative paths from the repository's root; default
``prod_overfit_torch_log.jsonl``); the last line of the output is the
JSON summary.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

import numpy as np
import torch

from .data.fixture import write_mini_opv2v
from .data.opv2v import HeteroCooperativeDataset
from .models.hmvit import HMViT
from .nn import init_parameters
from .postprocess import AnchorPostprocessor
from .serving import PROD_CFG, PROD_RANGE, batch_to_device
from .train.trainer import create_train_state, labels_for_batch, \
    make_forward, make_train_step
from .utils import evaluation as E
from .utils.boxes import boxes_to_corners_3d_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the AdamW of optax.adamw(lr): its weight decay default is 1e-4
ADAMW = {"betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": 1e-4}
# the oracle's logit for a positive anchor (sigmoid 0.99995) and the rest
ORACLE_LOGIT = 10.0
METRIC = ("production-scale overfit-to-AP (512^2 grid, 4x512^2 imgs x 5 "
          "slots, ResNet50+FPN, remat, bf16-AMP)")


def parse_args(argv=None):
    p = argparse.ArgumentParser("production-scale overfit-to-AP (PyTorch)")
    p.add_argument("--max_steps", type=int, default=3000)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--eval_every", type=int, default=100)
    p.add_argument("--target", type=float, default=0.9)
    p.add_argument("--target_metric", choices=["ap50", "ap70"],
                   default="ap70")
    p.add_argument("--patience", type=int, default=8,
                   help="stop after this many evaluations without the "
                        "watched AP improving")
    p.add_argument("--max_points", type=int, default=30000)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--num_cavs", type=int, default=4)
    p.add_argument("--grid", type=int, default=512,
                   help="pillar grid side (512 = production; smaller "
                        "values shrink every spatial size)")
    p.add_argument("--fp32", action="store_true",
                   help="float32 compute, the fusion included")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain twins; a rehearsal)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log", default="prod_overfit_torch_log.jsonl")
    return p.parse_args(argv)


def gate_config(grid: int, fp32: bool = False):
    """(model config, lidar range) of the gate: the production
    configuration with every spatial size scaled to a ``grid``^2 pillar
    grid, remat on every stage."""
    half_range = grid * 0.4 / 2.0
    lidar_range = [-half_range, -half_range, -3.0,
                   half_range, half_range, 1.0]
    cfg = copy.deepcopy(PROD_CFG)
    cfg["lidar"]["lidar_range"] = lidar_range
    cfg["lidar"]["point_pillar_scatter"]["grid_size"] = [grid, grid, 1]
    cfg["camera"]["bev_size"] = max(grid // 4, 8)
    cfg["camera"]["bev_range"] = half_range
    assert lidar_range == PROD_RANGE or grid != 512
    cfg["remat"] = True
    if fp32:
        for sub in ("lidar", "camera", "hetero_decoder"):
            cfg.get(sub, {}).pop("compute_dtype", None)
        cfg["hetero_fusion"]["hetero_fusion_block"]["compute_dtype"] = \
            "float32"
    return cfg, lidar_range


def postprocess_config(grid: int, lidar_range) -> dict:
    """The anchors, label thresholds and decode of the gate."""
    anchor_args = {"W": grid, "H": grid, "l": 3.9, "w": 1.6, "h": 1.56,
                   "r": [0, 90], "num": 2, "feature_stride": 4,
                   "vw": 0.4, "vh": 0.4, "cav_lidar_range": lidar_range}
    return {"anchor_args": anchor_args,
            "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45,
                            "score_threshold": 0.27},
            "order": "hwl", "max_num": 100, "nms_thresh": 0.15}


def write_fixture(root: str, grid: int, num_cavs: int, image_size: int,
                  max_points: int) -> None:
    """The gate's mini-OPV2V: one scenario of two frames; separated
    vehicles (rotated NMS would merge interpenetrating ones and cap the
    reachable AP under the target)."""
    half_range = grid * 0.4 / 2.0
    write_mini_opv2v(root, num_scenarios=1, num_cavs=num_cavs,
                     num_frames=2, image_size=image_size,
                     max_points=min(max_points, 16384),
                     min_separation=min(8.0, half_range * 0.35),
                     area=min(30.0, half_range * 0.7))


def dataset_params(root: str, lidar_range, image_size: int) -> dict:
    return {
        "train_params": {"max_cav": 5},
        "camera_to_lidar_ratio": 0.5,
        "ego_mode": "lidar",
        "preprocess": {
            "cav_lidar_range": lidar_range,
            "args": {"camera_preprocess": {
                "args": {"resize_x": image_size, "resize_y": image_size}}}},
        "postprocess": {"max_num": 100, "order": "hwl"},
        "root_dir": root, "validate_dir": root,
    }


def load_gate_data(args, lidar_range, pp: AnchorPostprocessor, anchors,
                   dev):
    """Write the fixture, load its frames (train mode, ``args.seed``),
    collate each into a batch of one; returns (batches on ``dev``, labels
    on ``dev``, ground-truth corners (N, 8, 3) float64 per frame, host ms
    per frame of loading)."""
    with tempfile.TemporaryDirectory(prefix="prod_overfit_opv2v_") as root:
        write_fixture(root, args.grid, args.num_cavs, args.image_size,
                      args.max_points)
        ds = HeteroCooperativeDataset(
            dataset_params(root, lidar_range, args.image_size), train=True,
            max_points=args.max_points, seed=args.seed)
        frames, load_ms = [], []
        for i in range(len(ds)):  # the modalities are drawn once
            t0 = time.perf_counter()
            frames.append(ds[i])
            load_ms.append((time.perf_counter() - t0) * 1e3)
    batches, labelses, gt_corners = [], [], []
    for f in frames:
        b = ds.collate_batch([f])
        labelses.append(labels_for_batch(pp, anchors, b, dev))
        gm = b["object_bbx_mask"][0] > 0
        gt_corners.append(boxes_to_corners_3d_np(
            np.asarray(b["object_bbx_center"][0])[gm], order="hwl"))
        batches.append(batch_to_device(
            {k: v for k, v in b.items() if k not in ("object_ids", "to_ego")},
            dev, bf16=False))
    return batches, labelses, gt_corners, float(np.median(load_ms))


def oracle_outputs(labels: dict) -> dict:
    """The outputs a perfect model would give on a frame: a high logit on
    every positive anchor, a low one elsewhere, and the regression
    targets as ``rm``; (1, A, H, W) and (1, 7A, H, W) float32."""
    pos = labels["pos_equal_one"]
    psm = torch.where(pos > 0, ORACLE_LOGIT, -ORACLE_LOGIT)
    return {"psm": psm.permute(0, 3, 1, 2).float(),
            "rm": labels["targets"].permute(0, 3, 1, 2).float()}


def average_precision(outputs, gt_corners, pp_eval: AnchorPostprocessor,
                      anchors):
    """(AP@0.3, AP@0.5, AP@0.7) of the frames' outputs (psm, rm) against
    their ground truth: ``post_process`` -> ``accumulate_frame`` ->
    ``final_results``."""
    stat = E.new_result_stat("iou")
    for out, gt_c in zip(outputs, gt_corners):
        corners, scores = pp_eval.post_process(
            {0: {"transformation_matrix": np.eye(4), "anchor_box": anchors,
                 "no_post_projection": True}},
            {0: {"psm": out["psm"].float(), "rm": out["rm"].float()}})
        if corners is None:
            corners, scores = np.zeros((0, 8, 3)), np.zeros((0,))
        E.accumulate_frame(corners, scores, gt_c, stat)
    res = E.final_results(stat)["iou"]
    return res["ap_30"], res["ap_50"], res["ap_70"]


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` prints
    them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def device_of(cpu: bool) -> torch.device:
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("prod_overfit: no CUDA device (pass --cpu to "
                         "rehearse on the CPU)")
    return torch.device("cuda", 0)


def run(argv=None) -> dict:
    """The gate; returns {"summary", "state", "batches", "labels",
    "gt_corners", "anchors", "cfg"} (the trained state for a caller that
    reads more of it)."""
    args = parse_args(argv)
    dev = device_of(args.cpu)
    kind = "cpu" if args.cpu else torch.cuda.get_device_name(0)
    card = "cpu" if args.cpu else card_line()
    cfg, lidar_range = gate_config(args.grid, args.fp32)
    pp_cfg = postprocess_config(args.grid, lidar_range)
    pp_train = AnchorPostprocessor(pp_cfg, train=True)
    pp_eval = AnchorPostprocessor(pp_cfg, train=False)
    anchors = pp_train.generate_anchor_box()
    batches, labelses, gt_cs, load_ms = load_gate_data(
        args, lidar_range, pp_train, anchors, dev)
    print(f"loaded {len(batches)} frames: {load_ms:.1f} ms a frame (host, "
          f"median), {[len(g) for g in gt_cs]} ground-truth boxes",
          flush=True)

    model = init_parameters(HMViT(cfg), seed=args.seed).to(dev)
    opt = torch.optim.AdamW(model.parameters(), lr=args.lr, **ADAMW)
    state = create_train_state(model, opt)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {n_params / 1e6:.1f} M params; device: {card}",
          flush=True)
    step_fn = make_train_step(model, opt, half=not args.fp32)
    fwd = make_forward(model)
    eval_ms = []

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def evaluate():
        outs = []
        for b in batches:
            sync()
            t0 = time.perf_counter()
            outs.append(fwd(state, b))
            sync()
            eval_ms.append((time.perf_counter() - t0) * 1e3)
        return average_precision(outs, gt_cs, pp_eval, anchors)

    log_path = os.path.join(REPO, args.log)
    t0 = time.time()
    best = (0.0, 0.0, 0.0)
    reached = None
    t_compile = None
    tgt_idx = {"ap30": 0, "ap50": 1, "ap70": 2}[args.target_metric]
    best_tgt = -1.0
    stale = 0
    steps_done = 0
    with open(log_path, "a") as lf:
        for step in range(args.max_steps):
            steps_done = step + 1
            i = step % len(batches)
            state, parts = step_fn(state, batches[i], labelses[i], 1)
            if step == 0:
                loss0 = float(parts["total_loss"])  # synchronises
                t_compile = time.time() - t0
                print(f"first step (build + run): {t_compile:.1f}s "
                      f"loss={loss0:.4f}", flush=True)
            if (step + 1) % args.eval_every == 0:
                loss = float(parts["total_loss"])
                ap30, ap50, ap70 = evaluate()
                rec = {"step": step + 1, "loss": round(loss, 4),
                       "ap30": round(ap30, 4), "ap50": round(ap50, 4),
                       "ap70": round(ap70, 4),
                       "wall_s": round(time.time() - t0, 1)}
                lf.write(json.dumps(rec) + "\n")
                lf.flush()
                print(rec, flush=True)
                cur = (ap30, ap50, ap70)
                if cur[tgt_idx] > best_tgt:
                    best_tgt, best, stale = cur[tgt_idx], cur, 0
                else:
                    stale += 1
                if cur[tgt_idx] >= args.target and reached is None:
                    reached = step + 1
                    break
                if stale >= args.patience:
                    print(f"plateau: {args.target_metric} flat for {stale} "
                          f"evals (best {best_tgt:.4f})", flush=True)
                    break

    wall = time.time() - t0
    summary = {
        "metric": METRIC,
        "ap30": best[0], "ap50": best[1], "ap70": best[2],
        "reached_target_at_step": reached,
        "max_steps": args.max_steps, "lr": args.lr,
        "compile_s": round(t_compile or 0.0, 1),
        "wall_s": round(wall, 1),
        # the steps run (the JAX script divides max_steps when a plateau
        # ends the run early)
        "steps_per_sec": round(
            steps_done / max(wall - (t_compile or 0), 1e-9), 3),
        "load_ms_per_frame": round(load_ms, 1),
        "eval_ms_per_frame": (round(float(np.median(eval_ms)), 1)
                              if eval_ms else None),
        "device": kind,
        "card": card,
    }
    print(json.dumps(summary), flush=True)
    return {"summary": summary, "state": state, "batches": batches,
            "labels": labelses, "gt_corners": gt_cs, "anchors": anchors,
            "cfg": cfg}


def main(argv=None) -> dict:
    return run(argv)["summary"]


if __name__ == "__main__":
    main()
