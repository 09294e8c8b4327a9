"""Evaluation CLI (port of ``hmvit_tpu/tools/inference.py``): a run
directory's config snapshot and last checkpoint, the validation split at
batch 1, decode + rotated NMS, IoU and distance AP, the table, and
``eval.yaml`` in the run directory.

Fusion methods:
  intermediate  one cooperative model on the whole fleet;
  no            the ego alone (the other agents masked out);
  early         every point cloud projected into the ego frame and
                merged on the ego's slot;
  late          each agent's frame through a single-agent forward in its
                own frame, the boxes projected to the ego and joined by
                NMS, optionally with a model per modality
                (``--camera_model_dir`` / ``--lidar_model_dir``).

The host decodes the next frame on a thread while the card runs the
current one; the copies to the card stay on the main thread.  After the
first frame, the end-to-end frames per second and the p50 / p95 frame
times are printed as one JSON line and stored under ``e2e``.

``--serving_buckets`` serves the intermediate forward of an HMViT (with
H3GAT or any ``fusion_override``; any other model serves its plain
forward) with the static hints of each frame's fleet (its camera count,
active agents, modality layout and ego modality): on the card through
:class:`hmvit_tpu_torch.graph_server.CompiledServer`, one captured CUDA
graph per (modality layout, active agents) bucket, whose captures are
stored under ``serving``; on the CPU as an eager forward with the same
hints.  ``--bf16`` casts the weights and every float input but the
geometry, calibration and raw points to bfloat16.

    python -m hmvit_tpu_torch.tools.inference --model_dir runs/<run>
        [--fusion_method intermediate|no|early|late] [--bf16]
        [--serving_buckets] [--ap_mode iou|distance|both]
        [--camera_to_lidar_ratio R] [--ego_mode m] [--synthetic]
        [--max_frames N] [--save_npy] [--save_vis] [--save_3d] [--cpu]

The detectors' outputs are read as the anchor heads' ``psm`` / ``rm``
or the anchor-free PIXOR maps ``cls`` / ``reg`` (decoded by the
config's postprocessor; the PIXOR boxes' BEV corners lifted to 3-D for
the evaluation).  A segmentation run directory (``seg_loss`` /
``vanilla_seg_loss``) is refused: the JAX tool evaluates detectors only.

``--save_vis`` writes each frame's BEV image (the ego's points, the
ground truth lime, the detections red) to ``model_dir/vis/%05d.png``,
drawn in numpy (:mod:`hmvit_tpu_torch.visualization.vis`);
``--save_3d`` writes every frame into one interactive viewer,
``model_dir/sequence.html`` (:mod:`~hmvit_tpu_torch.visualization.
viewer3d`); ``--save_npy`` the boxes as ``model_dir/npy/%04d_pred.npy``
/ ``_gt.npy``.

``--data_parallel`` (intermediate fusion only, as in the JAX tool)
spreads the frames over the processes of ``torchrun --nproc_per_node N
-m hmvit_tpu_torch.tools.inference ... --data_parallel`` (or of a
process group already made; alone, a world of one): each rank runs one
frame of every N, the outputs are gathered (``parallel.gather_batch``)
and rank 0 decodes and evaluates every frame, the padding of the last
round dropped; every rank returns the results.  It times no frames.

The flags are the JAX tool's, plus ``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser("hmvit_tpu_torch inference")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--camera_model_dir", default="")
    p.add_argument("--lidar_model_dir", default="")
    p.add_argument("--fusion_method", default="intermediate",
                   choices=["intermediate", "no", "early", "late"])
    p.add_argument("--ap_mode", default="both",
                   choices=["iou", "distance", "both"])
    p.add_argument("--camera_to_lidar_ratio", type=float, default=None)
    p.add_argument("--ego_mode", default=None)
    p.add_argument("--max_points", type=int, default=60000)
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_cavs", type=int, default=2,
                   help="fleet size of the generated mini-OPV2V fixture")
    p.add_argument("--synthetic_frames", type=int, default=4)
    p.add_argument("--bf16", action="store_true",
                   help="weights and non-geometry inputs in bfloat16")
    p.add_argument("--save_npy", action="store_true")
    p.add_argument("--save_vis", action="store_true")
    p.add_argument("--data_parallel", action="store_true")
    p.add_argument("--serving_buckets", action="store_true",
                   help="the static serving hints of each frame's fleet; on "
                        "the card one captured CUDA graph per bucket")
    p.add_argument("--save_3d", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (plain twins)")
    return p.parse_args(argv)


def detection_view(out: dict) -> dict:
    """A detector's outputs for the postprocessor: the anchor heads'
    ``psm`` / ``rm`` or the anchor-free ``cls`` / ``reg``."""
    keys = ("psm", "rm") if "psm" in out else ("cls", "reg")
    return {k: out[k] for k in keys}


def lift_corners(corners):
    """(N, 4, 2) anchor-free BEV corners -> (N, 8, 3) box corners (z from
    0 to a nominal 1.5 m), so that the evaluation takes every family
    alike; (N, 8, 3) corners and None pass through."""
    if corners is None or corners.ndim != 3 or corners.shape[1] == 8:
        return corners
    lo = np.concatenate([corners, np.zeros_like(corners[..., :1])], axis=-1)
    hi = lo + np.array([0.0, 0.0, 1.5])
    return np.concatenate([lo, hi], axis=1)


def fleet_hints(frame) -> dict:
    """The serving hints of one frame's fleet (the dispatcher's bucket
    key): the exact camera count, the active agents, the modality layout
    and the ego's modality."""
    from ..serving import serving_hints

    n_active = max(int(np.asarray(frame["agent_mask"]).sum()), 1)
    return serving_hints(np.asarray(frame["mode"]), n_active)


class GraphServing:
    """The intermediate forward of each frame's bucket as captured CUDA
    graphs (:class:`CompiledServer`, made at the first frame), with each
    bucket's capture time."""

    def __init__(self, model, anchors):
        import torch

        self.model = model
        self.anchors = torch.as_tensor(np.asarray(anchors),
                                       dtype=torch.float32).cuda()
        self.eye = torch.eye(4, device="cuda")
        self.server = None
        self.captures = []

    def __call__(self, request: dict, hints: dict) -> dict:
        import torch

        from ..graph_server import CompiledServer, _bucket_key

        key = _bucket_key(request, hints)
        new = self.server is None or key not in self.server.buckets
        t0 = time.perf_counter()
        if self.server is None:
            self.server = CompiledServer(self.model, hints, request,
                                         self.anchors, self.eye)
        bucket = self.server.load(request, hints)
        if new:
            torch.cuda.synchronize()
            self.captures.append({
                "hints": {k: (list(v) if isinstance(v, tuple) else v)
                          for k, v in hints.items()},
                "capture_s": round(time.perf_counter() - t0, 3),
                "launches": dict(bucket.launches)})
        return self.server.replay_forward(bucket)


def main(argv=None):
    args = parse_args(argv)
    if args.data_parallel and args.fusion_method != "intermediate":
        raise SystemExit("--data_parallel supports intermediate fusion only")

    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ..config import load_config
    from ..data.opv2v import HeteroCooperativeDataset
    from ..models.hmvit import HMViT
    from ..postprocess import build_postprocessor
    from ..serving import GEOMETRY_KEYS
    from ..utils import evaluation as E
    from ..utils.boxes import boxes_to_corners_3d_np
    from ..visualization.viewer3d import export_sequence_html
    from ..visualization.vis import visualize_bev
    from .common import device_of, load_runnable, to_device, \
        write_synthetic

    dev = device_of(args.cpu, "tools.inference")
    params = load_config("", model_dir=args.model_dir)
    from ..train.losses import SEG_LOSSES

    if params.get("loss", {}).get("core_method", "") in SEG_LOSSES:
        raise SystemExit(
            f"tools.inference: {args.model_dir} is a segmentation run "
            f"directory; this tool evaluates detectors only (box AP), as "
            f"the JAX package's tool does, which reads psm / rm or cls / "
            f"reg: there is no segmentation inference to port "
            f"(ROADMAP.md Queue 3, open, oracle)")
    if args.camera_to_lidar_ratio is not None:
        params["camera_to_lidar_ratio"] = args.camera_to_lidar_ratio
    if args.ego_mode is not None:
        params["ego_mode"] = args.ego_mode
    if args.synthetic:
        write_synthetic(params, "mini_opv2v_eval_", args.max_points,
                        num_scenarios=1, num_cavs=args.synthetic_cavs,
                        num_frames=args.synthetic_frames)

    dataset = HeteroCooperativeDataset(params, train=False,
                                       max_points=args.max_points)
    pp = build_postprocessor(params["postprocess"], train=False)
    anchors = pp.generate_anchor_box()

    def runnable(model_dir):
        model, _ = load_runnable(model_dir, dev)
        if args.bf16:
            model = model.to(torch.bfloat16)
        return model

    def prepare(batch):
        """A collated host batch on the device, with the bf16 casts."""
        out = to_device(batch, dev)
        if args.bf16:
            out = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32
                       and k not in GEOMETRY_KEYS else v)
                   for k, v in out.items()}
        return out

    model = runnable(args.model_dir)
    models = {"default": model}
    if args.fusion_method == "late":
        if args.camera_model_dir:
            models["camera"] = runnable(args.camera_model_dir)
        if args.lidar_model_dir:
            models["lidar"] = runnable(args.lidar_model_dir)
    # the serving hints of each frame's fleet (an HMViT only, with any
    # fusion, as the JAX tool's bucketed dispatch; any other model serves
    # its plain forward); on the card captured graphs
    hinted = (args.serving_buckets and args.fusion_method == "intermediate"
              and isinstance(model, HMViT))
    graphs = (GraphServing(model, anchors) if hinted and dev.type == "cuda"
              else None)

    def forward(m, batch, hints=None):
        if graphs is not None and hints is not None:
            return graphs(batch, hints)
        with torch.no_grad():
            return m(batch, **(hints or {}))

    stat = E.new_result_stat(args.ap_mode)
    n_frames = len(dataset) if not args.max_frames else min(
        len(dataset), args.max_frames)
    npy_dir = os.path.join(args.model_dir, "npy")
    if args.save_npy:
        os.makedirs(npy_dir, exist_ok=True)
    vis_dir = os.path.join(args.model_dir, "vis")
    if args.save_vis:
        os.makedirs(vis_dir, exist_ok=True)
    html_frames = []

    def score(i, frame, corners, scores):
        """Accumulate frame i's detections; returns its ground truth."""
        gt_mask = frame["object_bbx_mask"] > 0
        gt_corners = boxes_to_corners_3d_np(
            frame["object_bbx_center"][gt_mask], pp.order)
        E.accumulate_frame(corners, scores, gt_corners, stat)
        if args.save_npy:
            np.save(os.path.join(npy_dir, f"{i:04d}_pred.npy"),
                    corners if corners is not None else np.zeros((0, 8, 3)))
            np.save(os.path.join(npy_dir, f"{i:04d}_gt.npy"), gt_corners)
        return gt_corners

    if args.data_parallel:
        return data_parallel_eval(args, dataset, model, prepare, pp, anchors,
                                  stat, score, n_frames, dev)

    def produce(i):
        """Host decode and assembly of frame i (no device work)."""
        frame = dataset[i]
        if args.fusion_method == "late":
            return frame, [(sub, dataset.collate_batch([sub]))
                           for sub in dataset.late_fusion_frame(i)]
        if args.fusion_method == "early":
            frame = dataset.early_fusion_frame(i)
        elif args.fusion_method == "no":
            frame = dict(frame)
            frame["agent_mask"] = frame["agent_mask"].copy()
            frame["points_mask"] = frame["points_mask"].copy()
            frame["agent_mask"][1:] = 0
            frame["points_mask"][1:] = 0
            frame["record_len"] = np.int32(1)
        return frame, dataset.collate_batch([frame])

    prefetcher = ThreadPoolExecutor(max_workers=1)
    pending = prefetcher.submit(produce, 0) if n_frames else None
    t_e2e = None  # from the end of frame 0 (its forward builds and warms)
    frame_ms = []
    t_prev = None
    for i in range(n_frames):
        frame, payload = pending.result()
        if i + 1 < n_frames:
            pending = prefetcher.submit(produce, i + 1)
        if args.fusion_method == "late":
            data_dict, output_dict = {}, {}
            for ci, (sub, batch) in enumerate(payload):
                key = "camera" if sub["mode"][0] == 0 else "lidar"
                out = forward(models.get(key, models["default"]),
                              prepare(batch))
                data_dict[ci] = {"transformation_matrix": sub["to_ego"],
                                 "anchor_box": anchors}
                output_dict[ci] = detection_view(out)
            corners, scores = pp.post_process(data_dict, output_dict)
        else:
            hints = fleet_hints(frame) if hinted else None
            out = forward(model, prepare(payload), hints)
            corners, scores = pp.post_process(
                {"ego": {"transformation_matrix": np.eye(4),
                         "anchor_box": anchors,
                         "no_post_projection": True}},
                {"ego": detection_view(out)})
        corners = lift_corners(corners)
        if i == 0:
            t_e2e = t_prev = time.perf_counter()
        else:
            now = time.perf_counter()
            frame_ms.append((now - t_prev) * 1e3)
            t_prev = now

        gt_corners = score(i, frame, corners, scores)
        if args.save_vis or args.save_3d:
            points = frame["points"][0][frame["points_mask"][0] > 0]
        if args.save_vis:
            visualize_bev(points, corners, gt_corners,
                          params["preprocess"]["cav_lidar_range"],
                          save_path=os.path.join(vis_dir, f"{i:05d}.png"))
        if args.save_3d:
            html_frames.append({"points": points, "pred_corners": corners,
                                "gt_corners": gt_corners, "scores": scores})
    prefetcher.shutdown()
    if html_frames:
        export_sequence_html(os.path.join(args.model_dir, "sequence.html"),
                             html_frames)

    results = E.final_results(stat)
    if t_e2e is not None and n_frames > 1:
        wall = time.perf_counter() - t_e2e
        results["e2e"] = {"fps": round((n_frames - 1) / wall, 3),
                          "frames": n_frames - 1,
                          "wall_s": round(wall, 3),
                          "p50_ms": round(float(np.percentile(frame_ms, 50)),
                                          1),
                          "p95_ms": round(float(np.percentile(frame_ms, 95)),
                                          1)}
        print(json.dumps({"e2e_fps": results["e2e"]["fps"],
                          "frames": n_frames - 1,
                          "p50_ms": results["e2e"]["p50_ms"],
                          "p95_ms": results["e2e"]["p95_ms"]}))
    if graphs is not None:
        results["serving"] = {"captures": len(graphs.captures),
                              "buckets": graphs.captures}
        print(json.dumps({"graph_captures": len(graphs.captures),
                          "capture_s": [c["capture_s"]
                                        for c in graphs.captures]}))
    return report(args, results)


def report(args, results: dict) -> dict:
    """Print the AP table and write ``eval.yaml``; returns ``results``."""
    from ..data.codecs import yaml_dump

    if "iou" in results:
        print("AP@0.3 is %.3f\nAP@0.5 is %.3f\nAP@0.7 is %.3f"
              % (results["iou"]["ap_30"], results["iou"]["ap_50"],
                 results["iou"]["ap_70"]))
    if "distance" in results:
        for k, v in results["distance"].items():
            print(f"d{k} is {v:.3f}")
    with open(os.path.join(args.model_dir, "eval.yaml"), "w") as f:
        f.write(yaml_dump(results))
    return results


def data_parallel_eval(args, dataset, model, prepare, pp, anchors, stat,
                       score, n_frames, dev) -> dict:
    """``--data_parallel``: rounds of one frame a rank (the last round
    padded with its last frame, whose outputs are dropped), the outputs
    gathered to every rank, rank 0 scoring the real frames; the results
    broadcast, so every rank returns them."""
    import torch
    import torch.distributed as dist

    from ..parallel import gather_batch, init_from_env, make_mesh
    from ..utils import evaluation as E

    joined = not dist.is_initialized() and init_from_env(dev)
    mesh = make_mesh() if dist.is_initialized() else None
    world = dist.get_world_size() if mesh is not None else 1
    rank = dist.get_rank() if mesh is not None else 0
    for start in range(0, n_frames, world):
        idxs = list(range(start, min(start + world, n_frames)))
        mine = idxs[min(rank, len(idxs) - 1)]
        frame = dataset[mine]
        with torch.no_grad():
            out = model(prepare(dataset.collate_batch([frame])))
        out = detection_view(out)
        if mesh is not None:
            # gathered in float32 (exact; gloo takes no bfloat16)
            dtypes = {k: v.dtype for k, v in out.items()}
            out = {k: v.to(dtypes[k]) for k, v in gather_batch(
                {k: v.float() for k, v in out.items()}, mesh).items()}
        if rank != 0:
            continue
        for k, i in enumerate(idxs):
            fr = frame if i == mine else dataset[i]
            corners, scores = pp.post_process(
                {"ego": {"transformation_matrix": np.eye(4),
                         "anchor_box": anchors, "no_post_projection": True}},
                {"ego": {key: v[k:k + 1] for key, v in out.items()}})
            score(i, fr, lift_corners(corners), scores)
    results = [E.final_results(stat) if rank == 0 else None]
    if mesh is not None:
        dist.broadcast_object_list(results, src=0)
    if joined:
        dist.destroy_process_group()
    if rank != 0:
        return results[0]
    return report(args, results[0])


if __name__ == "__main__":
    main()
