"""Generate the hypes corpus (port of ``hmvit_tpu/config/generate_hypes.py``):
the same 73 configurations, byte for byte, written through the port's
own YAML writer (:func:`hmvit_tpu_torch.data.codecs.yaml_dump` with
``sort_keys=False``: insertion order, and PyYAML's anchors and aliases
for the lists and dicts the generators share between blocks).

    python -m hmvit_tpu_torch.config.generate_hypes [--out DIR]

writes ``DIR/<family>/<name>.yaml`` (default: the port's own
``config/hypes/``, whose copies it reproduces).
"""
from __future__ import annotations

import argparse
import os

from ..data.codecs import yaml_dump

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hypes")

RANGE = [-102.4, -102.4, -3, 102.4, 102.4, 1]
CAM_RANGE = [-51.2, -51.2, -3, 51.2, 51.2, 1]
PILLAR_VOXEL = [0.4, 0.4, 4]
IMAGENET = {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]}


def preprocess_block(voxel, rng):
    return {
        "core_method": "CamLiPreprocessor",
        "cav_lidar_range": rng,
        "args": {
            "camera_preprocess": {
                "core_method": "RgbPreprocessor",
                "args": {"bgr2rgb": True, "resize_x": 512,
                         "resize_y": 512, **IMAGENET},
                "cav_lidar_range": rng,
            },
            "lidar_preprocess": {
                "core_method": "DevicePillarVoxelizer",
                "args": {"voxel_size": voxel, "max_points_per_voxel": 32,
                         "max_points": 60000},
                "cav_lidar_range": rng,
            },
        },
    }


def postprocess_block(rng, stride=4):
    return {
        "core_method": "VoxelPostprocessor",
        "anchor_args": {"cav_lidar_range": rng, "l": 3.9, "w": 1.6,
                        "h": 1.56, "r": [0, 90],
                        "feature_stride": stride, "num": 2},
        "target_args": {"pos_threshold": 0.6, "neg_threshold": 0.45,
                        "score_threshold": 0.27},
        "order": "hwl", "max_num": 100, "nms_thresh": 0.15,
    }


def lidar_args(voxel, rng, grid):
    return {
        "voxel_size": voxel,
        "lidar_range": rng,
        "anchor_number": 2,
        "pillar_vfe": {"use_norm": True, "with_distance": False,
                       "use_absolute_xyz": True, "num_filters": [64]},
        "point_pillar_scatter": {"num_features": 64, "grid_size": grid},
        "base_bev_backbone": {
            "layer_nums": [3, 5, 8], "layer_strides": [2, 2, 2],
            "num_filters": [64, 128, 256],
            "upsample_strides": [1, 2, 4],
            "num_upsample_filter": [128, 128, 128]},
        "shrink_header": {"kernal_size": [3], "stride": [2],
                          "padding": [1], "dim": [256], "input_dim": 384},
    }


def camera_args(encoder):
    base = {"encoder": encoder, "dim": 128, "bev_size": 32,
            "out_dim": 256, "num_blocks": 2, "decoder_layers": 2,
            "img_size": 512, "encoder_channels": [32, 64, 128, 128]}
    if encoder == "bevformer":
        base.update(dim=256, bev_size=128, num_layers=3, heads=8,
                    window=8, lift="planar", backbone="resnet50",
                    id_pick=[2], num_points_in_pillar=4,
                    decoder_layers=0, bev_range=102.4)
    return base


def grid_of(rng, voxel):
    return [round((rng[3] - rng[0]) / voxel[0]),
            round((rng[4] - rng[1]) / voxel[1]),
            round((rng[5] - rng[2]) / voxel[2])]


def base(name, model, loss, parser, fusion_ds="IntermediateFusionDataset",
         rng=RANGE, voxel=PILLAR_VOXEL, ratio=0.0, ego="lidar",
         extra=None):
    cfg = {
        "name": name,
        "root_dir": "/data/opv2v/train",
        "validate_dir": "/data/opv2v/validate",
        "camera_to_lidar_ratio": ratio,
        "ego_mode": ego,
        "yaml_parser": [parser],
        "train_params": {"batch_size": 1, "epoches": 60, "eval_freq": 2,
                         "save_freq": 1, "max_cav": 5},
        "fusion": {"core_method": fusion_ds, "args": []},
        "data_augment": [],
        "preprocess": preprocess_block(voxel, rng),
        "postprocess": postprocess_block(rng),
        "model": model,
        "loss": loss,
        "optimizer": {"core_method": "AdamW", "lr": 2e-4,
                      "args": {"eps": 1e-10, "weight_decay": 1e-2}},
        "lr_scheduler": {"core_method": "cosineannealwarm", "epoches": 60,
                         "warmup_lr": 2e-5, "warmup_epoches": 10,
                         "lr_min": 5e-6},
    }
    if extra:
        cfg.update(extra)
    return cfg


DET_LOSS = {"core_method": "point_pillar_loss",
            "args": {"cls_weight": 1.0, "reg": 2.0}}
SEG_LOSS = {"core_method": "vanilla_seg_loss",
            "args": {"d_weights": 75.0, "s_weights": 15.0}}
SEG_EXT = {"add_data_extension": ["bev_dynamic.png", "bev_static.png",
                                  "bev_lane.png",
                                  "bev_visibility_corp.png"]}

HETERO_FUSION = {
    "num_iters": 2,
    "hetero_fusion_block": {
        "spatial_transform": {"downsample_rate": 4,
                              "voxel_size": PILLAR_VOXEL},
        "architect_mode": "sequential",
        "input_dim": 256, "mlp_dim": 256, "window_size": 8,
        "dim_head": 32, "drop_out": 0.0,
        "compute_dtype": "bfloat16",
    },
}


def write(root, group, name, cfg):
    """``root/group/name.yaml``, keys in insertion order, lists and
    dicts the generators share written as PyYAML's anchors and aliases
    (``yaml.safe_dump(cfg, sort_keys=False)``'s bytes)."""
    d = os.path.join(root, group)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, f"{name}.yaml"), "w") as f:
        f.write(yaml_dump(cfg, sort_keys=False))


def gen_opv2v(root):
    """Lidar-only families x {early, late, intermediate}."""
    fams = {
        "point_pillar": (PILLAR_VOXEL, "load_point_pillar_params"),
        "voxelnet": ([0.4, 0.4, 0.4], "load_voxel_params"),
        # SECOND's z chain (sparse_backbone_3d.py: 41 -> 21 -> 11 -> 5
        # -> 2) needs the reference's voxel z = 0.1 over the 4 m range;
        # xy stay 0.4 for the TPU-friendly 512^2 grid
        "second": ([0.4, 0.4, 0.1], "load_voxel_params"),
    }
    core = {"voxelnet": "voxel_net"}
    for fam, (voxel, parser) in fams.items():
        cm = core.get(fam, fam)
        grid = grid_of(RANGE, voxel)
        largs = lidar_args(voxel, RANGE, grid)
        if fam != "point_pillar":
            largs["grid_size"] = grid
            largs["vfe_filters"] = 32
        stride = 4
        if fam == "second":
            # reference second hypes: MeanVFE cap 5, BaseBEVBackbone
            # [5, 5] on the 256-ch height-compressed map, stride 8
            largs.pop("vfe_filters")
            largs["max_points_per_voxel"] = 5
            largs["base_bev_backbone"] = {
                "layer_nums": [5, 5], "layer_strides": [1, 2],
                "num_filters": [128, 256], "upsample_strides": [1, 2],
                "num_upsample_filter": [256, 256]}
            largs.pop("shrink_header", None)
            stride = 8
        for mode, ds in (("early_fusion", "EarlyFusionDataset"),
                         ("late_fusion", "LateFusionDataset")):
            model = {"core_method": cm,
                     "args": {"anchor_number": 2, "lidar": largs}}
            cfg = base(f"{fam}_{mode}", model, DET_LOSS, parser, ds,
                       voxel=voxel)
            cfg["postprocess"] = postprocess_block(RANGE, stride)
            write(root, "opv2v", f"{fam}_{mode}", cfg)
        inter = {"core_method": f"{cm}_intermediate",
                 "args": {"anchor_number": 2, "lidar": largs,
                          "spatial_transform": {
                              "downsample_rate": 4,
                              "voxel_size": voxel}}}
        cfg = base(f"{fam}_intermediate_fusion", inter, DET_LOSS, parser,
                   voxel=voxel)
        cfg["postprocess"] = postprocess_block(RANGE, stride)
        write(root, "opv2v", f"{fam}_intermediate_fusion", cfg)
    gen_pixor(root)


def gen_pixor(root):
    """Anchor-free PIXOR family (round-3 format: BevPostprocessor dense
    label grid, pixor_loss, the reference's 0.2 m / 704x160 BEV raster;
    reference: opencood/hypes_yaml/opv2v/pixor_late_fusion.yaml)."""
    rng = [-160.0, -40.0, -3.0, 160.0, 40.0, 1.0]
    voxel = [0.2, 0.2, 0.2]
    post = {
        "core_method": "BevPostprocessor",
        "nms_thresh": 0.15,
        "anchor_args": {"cav_lidar_range": rng, "res": 0.2,
                        "downsample_rate": 4},
        "target_args": {"score_threshold": 0.5},
        "order": "lwh", "max_num": 100,
    }
    loss = {"core_method": "pixor_loss",
            "args": {"alpha": 1.0, "beta": 1.0}}
    for mode, ds in (("early_fusion", "EarlyFusionDataset"),
                     ("late_fusion", "LateFusionDataset"),
                     ("intermediate_fusion", "IntermediateFusionDataset")):
        cm = "pixor_intermediate" if mode == "intermediate_fusion" \
            else "pixor"
        margs = {"use_bn": True, "decode": False}
        if cm == "pixor_intermediate":
            margs = dict(margs, spatial_transform={
                "downsample_rate": 4, "voxel_size": voxel})
        cfg = base(f"pixor_{mode}", {"core_method": cm, "args": margs},
                   loss, "load_bev_params", ds, rng=rng, voxel=voxel)
        cfg["preprocess"]["args"]["res"] = 0.2
        cfg["preprocess"]["args"]["downsample_rate"] = 4
        cfg["postprocess"] = post
        cfg["train_params"]["batch_size"] = 8
        cfg["train_params"]["epoches"] = 100
        cfg["optimizer"] = {"core_method": "Adam", "lr": 0.001,
                            "args": {"eps": 1.0e-10,
                                     "weight_decay": 0.0001}}
        cfg["lr_scheduler"] = {"core_method": "Exponential",
                               "gamma": 0.99}
        write(root, "opv2v", f"pixor_{mode}", cfg)


def gen_opcamera(root):
    """Camera-only segmentation families x fusions x {dynamic, static}."""
    cam_pp = postprocess_block(CAM_RANGE)
    cam_pp["seg_gt_size"] = 256

    def cam_base(name, model, extra=None):
        cfg = base(name, model, SEG_LOSS, "load_camera_params",
                   rng=CAM_RANGE, ratio=1.0, ego="camera",
                   extra={**SEG_EXT, **(extra or {})})
        cfg["postprocess"] = dict(cam_pp)
        return cfg

    singles = {
        "cvt": ("cvt_seg", "cvt"),
        "corpbevt_single": ("cvt_seg", "fax"),
        "view_parse_network": ("view_parse_network", "vpn"),
        "view_parse_network_ms": ("view_parse_network_ms", "vpn_ms"),
        "bev_swap": ("bev_swap", "bev_swap"),
    }
    for fname, (cm, enc) in singles.items():
        for tgt, suffix in (("dynamic", ""), ("static", "_static")):
            model = {"core_method": cm,
                     "args": {"target": tgt,
                              "camera": camera_args(enc)}}
            write(root, "opcamera", f"{fname}{suffix}",
                  cam_base(f"{fname}{suffix}", model))

    coop = {
        "cvt_att_fuse": "cross_view_transformer_att_fuse",
        "cvt_fcooper": "cross_view_transformer_fcooper",
        "cvt_disconet": "cross_view_transformer_disconet",
        "cvt_swap_fuse": "cross_view_transformer_swap_fuse",
        "cvt_v2vnet": "cross_view_transformer_v2vnet",
        "corpbevt": "corpbevt",
        "view_parse_network_att_fuse": "view_parse_network_att_fuse",
        "view_parse_network_fcooper": "view_parse_network_fcooper",
        "view_parse_network_swap_fuse": "view_parse_network_swap_fuse",
        "view_parse_network_v2vnet": "view_parse_network_v2vnet",
    }
    for fname, cm in coop.items():
        enc = "vpn" if "view_parse" in cm else (
            "fax" if cm == "corpbevt" else "cvt")
        for tgt, suffix in (("dynamic", ""), ("static", "_static")):
            model = {"core_method": cm,
                     "args": {"task": "seg", "target": tgt,
                              "anchor_number": 2,
                              "camera": camera_args(enc),
                              "spatial_transform": {
                                  "downsample_rate": 4,
                                  "voxel_size": PILLAR_VOXEL}}}
            write(root, "opcamera", f"{fname}{suffix}",
                  cam_base(f"{fname}{suffix}", model))


def gen_opcl(root):
    """Mixed camera+lidar families (the HM-ViT home turf)."""
    grid = grid_of(RANGE, PILLAR_VOXEL)
    largs = lidar_args(PILLAR_VOXEL, RANGE, grid)

    def mixed_model(cm, camera_enc, fusion_extra=None):
        args = {"anchor_number": 2,
                "camera": camera_args(camera_enc),
                "lidar": largs,
                "compression": 0,
                "spatial_transform": {"downsample_rate": 4,
                                      "voxel_size": PILLAR_VOXEL},
                "hetero_decoder": {"input_dim": 256, "num_layer": 2,
                                   "num_ch_dec": [256, 256],
                                   "anchor_number": 2}}
        if fusion_extra:
            args.update(fusion_extra)
        return {"core_method": cm, "args": args}

    for enc in ("fax", "bevformer"):
        write(root, "opcl", f"{enc}_point_pillar_hetero",
              base(f"{enc}_point_pillar_hetero",
                   mixed_model(f"{enc}_point_pillar_hetero", enc,
                               {"hetero_fusion": HETERO_FUSION}),
                   DET_LOSS, "load_camera_point_pillar_params",
                   ratio=0.5, ego="mixed"))
        for fuse in ("att_fuse", "v2vnet", "v2xt", "fax"):
            cm = f"{enc}_point_pillar_{fuse}"
            write(root, "opcl", cm,
                  base(cm, mixed_model(cm, enc), DET_LOSS,
                       "load_camera_point_pillar_params",
                       ratio=0.5, ego="mixed"))
    for cm in ("bevformer_point_pillar_disconet",
               "fax_point_pillar_fcooper",
               "point_pillar_cross_view_transformer_f_cooper"):
        enc = "bevformer" if cm.startswith("bevformer") else (
            "cvt" if "cross_view" in cm else "fax")
        write(root, "opcl", cm,
              base(cm, mixed_model(cm, enc), DET_LOSS,
                   "load_camera_point_pillar_params",
                   ratio=0.5, ego="mixed"))
    # per-modality late fusion checkpoints (mixed no/late fusion eval)
    for name, enc, ratio, ego in (
            ("fax_late_fusion", "fax", 1.0, "camera"),
            ("bevformer_late_fusion", "bevformer", 1.0, "camera"),
            ("lidar_point_pillar_late_fusion", "fax", 0.0, "lidar")):
        cm = "point_pillar" if ratio == 0.0 else "cvt_nofusion"
        model = ({"core_method": "point_pillar",
                  "args": {"anchor_number": 2, "lidar": largs}}
                 if ratio == 0.0 else
                 {"core_method": "cross_view_transformer",
                  "args": {"anchor_number": 2,
                           "camera": camera_args(enc)}})
        write(root, "opcl", name,
              base(name, model, DET_LOSS,
                   "load_camera_point_pillar_params",
                   fusion_ds="LateFusionDataset", ratio=ratio, ego=ego))


def gen_v2xt(root):
    """V2X-ViT lidar family."""
    grid = grid_of(RANGE, PILLAR_VOXEL)
    largs = lidar_args(PILLAR_VOXEL, RANGE, grid)
    for name, cm, ds in (
            ("point_pillar_early_fusion", "point_pillar",
             "EarlyFusionDataset"),
            ("point_pillar_late_fusion", "point_pillar",
             "LateFusionDataset"),
            ("point_pillar_fcooper", "point_pillar_fcooper",
             "IntermediateFusionDataset"),
            ("point_pillar_opv2v", "point_pillar_opv2v",
             "IntermediateFusionDataset"),
            ("point_pillar_intermediate", "point_pillar_intermediate",
             "IntermediateFusionDataset"),
            ("point_pillar_transformer", "point_pillar_transformer",
             "IntermediateFusionDataset")):
        args = {"anchor_number": 2, "lidar": largs,
                "spatial_transform": {"downsample_rate": 4,
                                      "voxel_size": PILLAR_VOXEL}}
        write(root, "v2xt", name,
              base(name, {"core_method": cm, "args": args}, DET_LOSS,
                   "load_point_pillar_params", ds,
                   extra={"wild_setting": {
                       "async": True, "async_mode": "sim",
                       "async_overhead": 1, "loc_err": True,
                       "xyz_std": 0.2, "ryp_std": 0.2}}))


def gen_exact_twins(root):
    """Exact-name twins for the remaining reference launch lines, so
    every ``--hypes_yaml opencood/hypes_yaml/<family>/<name>.yaml``
    ports verbatim (reference files cited per config)."""
    # --- opcamera/fax.yaml + bevt_static.yaml: FAX ("fused transformer")
    # single-vehicle seg (reference: opencood/hypes_yaml/opcamera/
    # {fax,bevt_static}.yaml, core_method fax_fused_transformer)
    cam_pp = postprocess_block(CAM_RANGE)
    cam_pp["seg_gt_size"] = 256
    for fname, tgt in (("fax", "dynamic"), ("bevt_static", "static")):
        model = {"core_method": "fax_fused_transformer",
                 "args": {"target": tgt, "camera": camera_args("fax")}}
        cfg = base(fname, model, SEG_LOSS, "load_camera_params",
                   fusion_ds="CamLateFusionDataset", rng=CAM_RANGE,
                   ratio=1.0, ego="camera", extra=dict(SEG_EXT))
        cfg["postprocess"] = dict(cam_pp)
        write(root, "opcamera", fname, cfg)

    # --- opcamera/base_camera.yaml: model-less data-api demonstration
    # (reference file says "only used for demonstration data api")
    demo = base("base_camera", None, SEG_LOSS, "load_camera_params",
                fusion_ds="CamLateFusionDataset", rng=CAM_RANGE,
                ratio=1.0, ego="camera", extra=dict(SEG_EXT))
    del demo["model"]
    demo["postprocess"] = dict(cam_pp)
    write(root, "opcamera", "base_camera", demo)

    # --- opcl exact-name twins (reference: opencood/hypes_yaml/opcl/)
    grid = grid_of(RANGE, PILLAR_VOXEL)
    largs = lidar_args(PILLAR_VOXEL, RANGE, grid)

    def opcl_mixed(name, cm, enc, ratio, ego):
        args = {"anchor_number": 2, "camera": camera_args(enc),
                "lidar": largs, "compression": 0,
                "spatial_transform": {"downsample_rate": 4,
                                      "voxel_size": PILLAR_VOXEL},
                "hetero_decoder": {"input_dim": 256, "num_layer": 2,
                                   "num_ch_dec": [256, 256],
                                   "anchor_number": 2}}
        write(root, "opcl", name,
              base(name, {"core_method": cm, "args": args}, DET_LOSS,
                   "load_camera_point_pillar_params", ratio=ratio,
                   ego=ego))

    # corpbevt.yaml -> point_pillar_cross_view_transformer_f_cooper
    opcl_mixed("corpbevt", "point_pillar_cross_view_transformer_f_cooper",
               "cvt", 0.5, "mixed")
    # fax_att_fuse.yaml -> fax_point_pillar_att_fuse (all-camera fleet)
    opcl_mixed("fax_att_fuse", "fax_point_pillar_att_fuse", "fax",
               1.0, "camera")
    # point_pillar_att_fuse.yaml -> bevformer_point_pillar_att_fuse
    # (all-lidar fleet: the camera branch never activates)
    opcl_mixed("point_pillar_att_fuse", "bevformer_point_pillar_att_fuse",
               "bevformer", 0.0, "lidar")
    # point_pillar_late_fusion.yaml -> single-agent point_pillar on the
    # CamLi late-fusion data path
    write(root, "opcl", "point_pillar_late_fusion",
          base("point_pillar_late_fusion",
               {"core_method": "point_pillar",
                "args": {"anchor_number": 2, "lidar": largs}},
               DET_LOSS, "load_camera_point_pillar_params",
               fusion_ds="CamLiLateFusionDataset", ratio=0.0,
               ego="lidar"))

    # --- visualization.yaml x2: model-less early-fusion data configs
    # used only to drive the sequence renderer (reference:
    # opencood/hypes_yaml/{opv2v,v2xt}/visualization.yaml)
    for fam in ("opv2v", "v2xt"):
        vis = base("visualization", None, DET_LOSS, "load_voxel_params",
                   fusion_ds="EarlyFusionDataset",
                   voxel=[0.4, 0.4, 0.4])
        del vis["model"]
        del vis["loss"]
        write(root, fam, "visualization", vis)


GENERATORS = (gen_opv2v, gen_opcamera, gen_opcl, gen_v2xt, gen_exact_twins)


def generate(root: str = HERE) -> list:
    """Write every configuration under ``root``; returns the paths of
    the YAML files under ``root``, relative to it, sorted."""
    for gen in GENERATORS:
        gen(root)
    return sorted(os.path.relpath(os.path.join(d, name), root)
                  for d, _, files in os.walk(root) for name in files
                  if name.endswith(".yaml"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser("hmvit_tpu_torch.config.generate_hypes")
    p.add_argument("--out", default=HERE,
                   help="output root (default: the port's config/hypes)")
    out = p.parse_args(argv).out
    print(f"hypes corpus generated under {out} "
          f"({len(generate(out))} files)")
    return 0


if __name__ == "__main__":
    main()
