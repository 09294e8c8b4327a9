"""Reference-checkpoint converter (port of
``hmvit_tpu/tools/convert_checkpoint.py``): a reference run's
``net_epoch%d.pth`` state_dict -> a checkpoint of the port that
``tools.inference --model_dir`` serves, and back.

The reference saves plain ``model.state_dict()`` files named
``net_epoch%d.pth`` in its run directory.  The importers map such a
state_dict, key by key, onto the flax-named tree of the reference-
faithful twins (the JAX package's names, which the port's modules
carry); :func:`hmvit_tpu_torch.bridge.flax_to_state_dict` of the model
that ``--hypes`` builds turns that tree into the port's state_dict, and
the CLI writes it with ``train/checkpointing.save_checkpoint`` at step
0:

  python -m hmvit_tpu_torch.tools.convert_checkpoint \\
      --from_reference <run_dir | net_epochN.pth> \\
      --core_method bevformer_point_pillar_hetero \\
      --hypes <run_dir>/config.yaml --output <run_dir>/ckpt

The run directory's ``config.yaml`` is the user's (the flagship's with
``camera.encoder: bevformer_ref``); the converter writes none.  The
reverse direction, ``--from_run <run_dir> --to_reference out.pth``,
reads the run's last checkpoint back into the flax-named tree
(:func:`hmvit_tpu_torch.bridge.state_dict_to_flax`) and writes the
reference's key layout (:func:`export_flagship`).

The conversions: ``point_pillar`` (the whole detector),
``bevformer_point_pillar_hetero`` (the flagship: the BEVFormer twin,
PointPillars, H3GAT, the hetero decoder), ``bevformer_wrapper`` (the
standalone BEVFormer detector), and the subtrees ``fax``
(``RefFAXModule``), ``cvt`` (``RefCrossViewModule``), ``hetero_fusion``
(``HeteroFusion``) and ``bevformer`` (``RefBEVFormer``), each written
into the one module of its class in the model of ``--hypes`` (the rest
of that model keeps the seeded initialisation of seed 0, as a run
directory without a checkpoint does: ``conversion_report.json`` names
the filled module under ``filled_module`` and counts the rest under
``seed_initialised_params``, and the CLI warns on stderr).  Array
layouts: conv NCHW -> HWIO, the transposed conv's kernel flip, the
linear's transpose, torch BatchNorm -> scale / bias + mean / var.  The keys a conversion does not
consume are reported.  Everything runs on the CPU, in numpy: the
conversion has no device work.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

import numpy as np
import torch


# ---------------------------------------------------------------------
# state_dict access + array-layout converters
# ---------------------------------------------------------------------
class StateDict:
    """A torch state_dict (name -> numpy) that records consumed keys."""

    def __init__(self, raw: dict):
        self.raw = {k: np.asarray(v) for k, v in raw.items()}
        self.used: set[str] = set()

    def take(self, key: str) -> np.ndarray:
        if key not in self.raw:
            raise KeyError(
                f"reference checkpoint is missing {key!r} — wrong "
                f"--core_method / --prefix, or a different model family")
        self.used.add(key)
        return self.raw[key]

    def has(self, key: str) -> bool:
        return key in self.raw

    def unused(self) -> list[str]:
        # num_batches_tracked / relative_position_index carry no
        # information (BN step counters; constant index tables we
        # recompute host-side)
        skip = ("num_batches_tracked", "relative_position_index")
        return sorted(
            k for k in self.raw
            if k not in self.used and not k.endswith(skip)
        )

    def sub(self, prefix: str) -> "StateDict":
        """A view of this state_dict under ``prefix`` ('' = identity);
        consumption is recorded on the parent."""
        if not prefix:
            return self
        return _PrefixView(self, prefix)

    def mark_dead(self, prefixes: list[str]) -> list[str]:
        """Consume every key under the given prefixes without mapping
        them — for reference submodules that exist in the checkpoint
        but are DEAD in the forward being ported (e.g. the BEVFormer
        detection head under only_bev).  Returns the consumed keys."""
        dead = [k for k in self.raw if not (k in self.used) and any(
            k == p or k.startswith(p + ".") for p in prefixes)]
        self.used.update(dead)
        return sorted(dead)


class _PrefixView:
    """StateDict view that prepends a fixed key prefix."""

    def __init__(self, parent, prefix: str):
        self._p = parent
        self._prefix = prefix.rstrip(".") + "."

    def take(self, key: str) -> np.ndarray:
        return self._p.take(self._prefix + key)

    def has(self, key: str) -> bool:
        return self._p.has(self._prefix + key)

    def sub(self, prefix: str):
        return self._p.sub(self._prefix + prefix)


def conv(sd: StateDict, p: str) -> dict:
    """torch Conv2d (out, in, kh, kw) -> flax Conv (kh, kw, in, out)."""
    out = {"kernel": sd.take(f"{p}.weight").transpose(2, 3, 1, 0)}
    if sd.has(f"{p}.bias"):
        out["bias"] = sd.take(f"{p}.bias")
    return out


def conv_transpose(sd: StateDict, p: str) -> dict:
    """torch ConvTranspose2d (in, out, kh, kw) -> flax ConvTranspose
    (kh, kw, in, out) with the spatial flip (flax's conv_transpose does
    not flip kernels; torch's adjoint-conv semantics do)."""
    w = sd.take(f"{p}.weight")[:, :, ::-1, ::-1]
    out = {"kernel": np.ascontiguousarray(w.transpose(2, 3, 0, 1))}
    if sd.has(f"{p}.bias"):
        out["bias"] = sd.take(f"{p}.bias")
    return out


def linear(sd: StateDict, p: str) -> dict:
    out = {"kernel": sd.take(f"{p}.weight").T}
    if sd.has(f"{p}.bias"):
        out["bias"] = sd.take(f"{p}.bias")
    return out


def layernorm(sd: StateDict, p: str) -> dict:
    return {"scale": sd.take(f"{p}.weight"), "bias": sd.take(f"{p}.bias")}


def batchnorm(sd: StateDict, p: str) -> tuple[dict, dict]:
    """-> (params {scale, bias}, batch_stats {mean, var})."""
    return (
        {"scale": sd.take(f"{p}.weight"), "bias": sd.take(f"{p}.bias")},
        {"mean": sd.take(f"{p}.running_mean"),
         "var": sd.take(f"{p}.running_var")},
    )


# ---------------------------------------------------------------------
# point_pillar: the full lidar detector
# ---------------------------------------------------------------------
def convert_point_pillar_encoder(sd, margs: dict) -> tuple[dict, dict]:
    """Reference PointPillar ENCODER subtree (VFE -> scatter -> BEV
    backbone -> shrink) -> PointPillarEncoder (params, batch_stats).
    ``sd`` may be a prefix view (e.g. ``lidar_encoder.`` inside the
    flagship, reference bevformer_point_pillar_hetero.py:56)."""
    enc_params: dict = {}
    enc_stats: dict = {}

    # PillarVFE -> PillarFeatureNet_0 (Dense_i + MaskedBatchNorm_i).
    # The flax module computes masked statistics; at inference both use
    # the stored running stats, so the mapping is exact.
    pfn_p, pfn_s = {}, {}
    i = 0
    while sd.has(f"pillar_vfe.pfn_layers.{i}.linear.weight"):
        pfn_p[f"Dense_{i}"] = linear(sd, f"pillar_vfe.pfn_layers.{i}.linear")
        bnp, bns = batchnorm(sd, f"pillar_vfe.pfn_layers.{i}.norm")
        pfn_p[f"MaskedBatchNorm_{i}"] = bnp
        pfn_s[f"MaskedBatchNorm_{i}"] = bns
        i += 1
    if i == 0:
        raise KeyError("no pillar_vfe.pfn_layers.* keys found")
    enc_params["PillarFeatureNet_0"] = pfn_p
    enc_stats["PillarFeatureNet_0"] = pfn_s

    # BaseBEVBackbone -> BEVBackbone_0.  Reference block layout
    # (base_bev_backbone.py:40-57): [ZeroPad, Conv, BN, ReLU] +
    # [Conv, BN, ReLU] * layer_nums[si]; deblocks: [ConvT|Conv, BN, ReLU].
    bb = margs["base_bev_backbone"]
    bb_p, bb_s = {}, {}
    ci = 0
    n_convT = n_conv = 0
    for si, n_layers in enumerate(bb["layer_nums"]):
        idxs = [1] + [4 + 3 * k for k in range(n_layers)]
        for idx in idxs:
            bb_p[f"ConvBNReLU_{ci}"] = {
                "Conv_0": conv(sd, f"backbone.blocks.{si}.{idx}")}
            bnp, bns = batchnorm(sd, f"backbone.blocks.{si}.{idx + 1}")
            bb_p[f"ConvBNReLU_{ci}"]["BatchNorm_0"] = bnp
            bb_s[f"ConvBNReLU_{ci}"] = {"BatchNorm_0": bns}
            ci += 1
        stride = bb["upsample_strides"][si]
        de = f"backbone.deblocks.{si}"
        if stride >= 1:
            bb_p[f"ConvTranspose_{n_convT}"] = conv_transpose(sd, f"{de}.0")
            n_convT += 1
        else:
            bb_p[f"Conv_{n_conv}"] = conv(sd, f"{de}.0")
            n_conv += 1
        bnp, bns = batchnorm(sd, f"{de}.1")
        bb_p[f"BatchNorm_{si}"] = bnp
        bb_s[f"BatchNorm_{si}"] = bns
    enc_params["BEVBackbone_0"] = bb_p
    enc_stats["BEVBackbone_0"] = bb_s

    # DownsampleConv (shrink header) -> DownsampleConv_0
    if "shrink_header" in margs:
        dc_p = {}
        for li in range(len(margs["shrink_header"]["dim"])):
            base = f"shrink_conv.layers.{li}.double_conv"
            dc_p[f"DoubleConv_{li}"] = {
                "Conv_0": conv(sd, f"{base}.0"),
                "Conv_1": conv(sd, f"{base}.2"),
            }
        enc_params["DownsampleConv_0"] = dc_p
    return enc_params, enc_stats


def convert_point_pillar(sd: StateDict, margs: dict) -> dict:
    """Reference PointPillar state_dict -> PointPillarDetector variables.

    Key layout being consumed (reference point_pillar.py:9-40):
      pillar_vfe.pfn_layers.{i}.linear / .norm
      backbone.blocks.{si}.{1,2,4,5,...} / backbone.deblocks.{si}.{0,1}
      shrink_conv.layers.{i}.double_conv.{0,2}
      cls_head / reg_head
    """
    enc_params, enc_stats = convert_point_pillar_encoder(sd, margs)
    params = {"PointPillarEncoder_0": enc_params,
              "DetectionHead_0": {"Conv_0": conv(sd, "cls_head"),
                                  "Conv_1": conv(sd, "reg_head")}}
    stats = {"PointPillarEncoder_0": enc_stats}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------
# FAX / CVT camera->BEV subtrees
# ---------------------------------------------------------------------
def _attend(sd: StateDict, p: str) -> dict:
    """Reference fax Attend block (to_q/to_k/to_v: [LN, Linear]) ->
    fax_ref attention params."""
    return {
        "to_q_norm": layernorm(sd, f"{p}.to_q.0"),
        "to_q": linear(sd, f"{p}.to_q.1"),
        "to_k_norm": layernorm(sd, f"{p}.to_k.0"),
        "to_k": linear(sd, f"{p}.to_k.1"),
        "to_v_norm": layernorm(sd, f"{p}.to_v.0"),
        "to_v": linear(sd, f"{p}.to_v.1"),
        "proj": linear(sd, f"{p}.proj"),
    }


def _fax_cva(sd: StateDict, p: str) -> tuple[dict, dict]:
    """Reference CrossViewSwapAttention subtree at prefix ``p`` ->
    (params, stats) for fax_ref.RefCrossViewSwapAttention."""
    params = {
        "cam_embed": conv(sd, f"{p}.cam_embed"),
        "img_embed": conv(sd, f"{p}.img_embed"),
        "feature_proj": conv(sd, f"{p}.feature_proj.2"),
        "feature_linear": conv(sd, f"{p}.feature_linear.2"),
        "cross_win_attend_1": _attend(sd, f"{p}.cross_win_attend_1"),
        "cross_win_attend_2": _attend(sd, f"{p}.cross_win_attend_2"),
        "prenorm_1": layernorm(sd, f"{p}.prenorm_1"),
        "prenorm_2": layernorm(sd, f"{p}.prenorm_2"),
        "postnorm": layernorm(sd, f"{p}.postnorm"),
        "mlp_1_fc1": linear(sd, f"{p}.mlp_1.0"),
        "mlp_1_fc2": linear(sd, f"{p}.mlp_1.2"),
        "mlp_2_fc1": linear(sd, f"{p}.mlp_2.0"),
        "mlp_2_fc2": linear(sd, f"{p}.mlp_2.2"),
    }
    if sd.has(f"{p}.bev_embed.weight"):
        params["bev_embed"] = conv(sd, f"{p}.bev_embed")
    stats = {}
    for name in ("feature_proj", "feature_linear"):
        bnp, bns = batchnorm(sd, f"{p}.{name}.0")
        params[f"{name}_bn"] = bnp
        stats[f"{name}_bn"] = bns
    return params, stats


def _bottlenecks(sd: StateDict, p: str, params: dict, stats: dict,
                 out_key: str) -> None:
    """layers.{i} = Sequential of torchvision Bottlenecks -> layers_{i}_{j}
    param groups (conv1..3 + bn1..3, optional downsample)."""
    j = 0
    while sd.has(f"{p}.{j}.conv1.weight"):
        bp, bs = {}, {}
        for k in (1, 2, 3):
            bp[f"conv{k}"] = conv(sd, f"{p}.{j}.conv{k}")
            bnp, bns = batchnorm(sd, f"{p}.{j}.bn{k}")
            bp[f"bn{k}"] = bnp
            bs[f"bn{k}"] = bns
        if sd.has(f"{p}.{j}.downsample.0.weight"):
            bp["downsample_conv"] = conv(sd, f"{p}.{j}.downsample.0")
            bnp, bns = batchnorm(sd, f"{p}.{j}.downsample.1")
            bp["downsample_bn"] = bnp
            bs["downsample_bn"] = bns
        params[f"{out_key}_{j}"] = bp
        stats[f"{out_key}_{j}"] = bs
        j += 1


def convert_fax_module(sd: StateDict, prefix: str = "fax") -> dict:
    """Reference FAXModule subtree -> fax_ref.RefFAXModule variables."""
    p, s = {}, {}
    p["bev_embedding"] = {"learned_features": sd.take(
        f"{prefix}.bev_embedding.learned_features")}
    i = 0
    while sd.has(f"{prefix}.cross_views.{i}.cam_embed.weight"):
        cp, cs = _fax_cva(sd, f"{prefix}.cross_views.{i}")
        p[f"cross_views_{i}"] = cp
        s[f"cross_views_{i}"] = cs
        _bottlenecks(sd, f"{prefix}.layers.{i}", p, s, f"layers_{i}")
        i += 1
    if i == 0:
        raise KeyError(f"no {prefix}.cross_views.* keys found")
    j = 0
    while sd.has(f"{prefix}.downsample_layers.{j}.0.0.weight"):
        base = f"{prefix}.downsample_layers.{j}.0"
        dp = {"conv_pre": conv(sd, f"{base}.0"),
              "conv_mid": conv(sd, f"{base}.2"),
              "conv_post": conv(sd, f"{base}.5")}
        ds = {}
        for name, idx in (("bn_mid", 3), ("bn_post", 6)):
            bnp, bns = batchnorm(sd, f"{base}.{idx}")
            dp[name] = bnp
            ds[name] = bns
        p[f"downsample_layers_{j}"] = dp
        s[f"downsample_layers_{j}"] = ds
        j += 1
    p["self_attn"] = {
        "to_qkv": linear(sd, f"{prefix}.self_attn.to_qkv"),
        "to_out": linear(sd, f"{prefix}.self_attn.to_out.0"),
        "rel_pos_bias": sd.take(f"{prefix}.self_attn.rel_pos_bias.weight"),
    }
    return {"params": p, "batch_stats": s}


def convert_cvt_module(sd: StateDict, prefix: str = "cvm") -> dict:
    """Reference CVT CrossViewModule subtree ->
    cvt_ref.RefCrossViewModule variables."""
    p: dict = {"bev_embedding_learned_features": sd.take(
        f"{prefix}.bev_embedding.learned_features")}
    s: dict = {}
    i = 0
    while sd.has(f"{prefix}.cross_views.{i}.cam_embed.weight"):
        base = f"{prefix}.cross_views.{i}"
        ca = f"{base}.cross_attend"
        cp = {
            "cam_embed": conv(sd, f"{base}.cam_embed"),
            "img_embed": conv(sd, f"{base}.img_embed"),
            "bev_embed": conv(sd, f"{base}.bev_embed"),
            "feature_proj": conv(sd, f"{base}.feature_proj.2"),
            "feature_linear": conv(sd, f"{base}.feature_linear.2"),
            "cross_attend": {
                "to_q_norm": layernorm(sd, f"{ca}.to_q.0"),
                "to_q": linear(sd, f"{ca}.to_q.1"),
                "to_k_norm": layernorm(sd, f"{ca}.to_k.0"),
                "to_k": linear(sd, f"{ca}.to_k.1"),
                "to_v_norm": layernorm(sd, f"{ca}.to_v.0"),
                "to_v": linear(sd, f"{ca}.to_v.1"),
                "proj": linear(sd, f"{ca}.proj"),
                "prenorm": layernorm(sd, f"{ca}.prenorm"),
                "postnorm": layernorm(sd, f"{ca}.postnorm"),
                "mlp_fc1": linear(sd, f"{ca}.mlp.0"),
                "mlp_fc2": linear(sd, f"{ca}.mlp.2"),
            },
        }
        cs = {}
        for name in ("feature_proj", "feature_linear"):
            bnp, bns = batchnorm(sd, f"{base}.{name}.0")
            cp[f"{name}_bn"] = bnp
            cs[f"{name}_bn"] = bns
        p[f"cross_views_{i}"] = cp
        s[f"cross_views_{i}"] = cs
        _bottlenecks(sd, f"{prefix}.layers.{i}", p, s, f"layers_{i}")
        i += 1
    if i == 0:
        raise KeyError(f"no {prefix}.cross_views.* keys found")
    return {"params": p, "batch_stats": s}


# ---------------------------------------------------------------------
# H3GAT hetero-fusion trunk
# ---------------------------------------------------------------------
def _stacked_linear(sd: StateDict, fmt: str, n_types: int = 2) -> dict:
    """Per-type torch Linears -> one stacked HeteroDense
    {kernel (T, din, dout), bias (T, dout)}."""
    ks = [sd.take(fmt.format(t) + ".weight").T for t in range(n_types)]
    bs = [sd.take(fmt.format(t) + ".bias") for t in range(n_types)]
    return {"kernel": np.stack(ks), "bias": np.stack(bs)}


def _hetero_ln(sd: StateDict, p: str, n_types: int = 2) -> dict:
    """Reference HeteroLayerNorm (per-type nn.LayerNorm under .net.{t})
    -> stacked {scale (T, c), bias (T, c)}."""
    return {"scale": np.stack([sd.take(f"{p}.net.{t}.weight")
                               for t in range(n_types)]),
            "bias": np.stack([sd.take(f"{p}.net.{t}.bias")
                              for t in range(n_types)])}


def _hetero_ffn(sd: StateDict, p: str, n_types: int = 2) -> dict:
    """Reference HeteroFeedForward (.net.{t} = Sequential[Linear, GELU,
    Dropout, Linear, Dropout]) -> {HeteroDense_0, HeteroDense_1}."""
    return {"HeteroDense_0": _stacked_linear(sd, p + ".net.{}.0", n_types),
            "HeteroDense_1": _stacked_linear(sd, p + ".net.{}.3", n_types)}


def _hetero_attn(sd: StateDict, p: str, n_types: int = 2) -> dict:
    """Reference HeteroAttention -> HeteroWindowAttention params.

    relation_msg convention: the reference applies W^T v
    (hetero_fusion.py:263); ours applies W v — transposed on import
    (same mapping the golden parity test uses)."""
    return {
        "to_q": _stacked_linear(sd, p + ".q_linears.{}", n_types),
        "to_k": _stacked_linear(sd, p + ".k_linears.{}", n_types),
        "to_v": _stacked_linear(sd, p + ".v_linears.{}", n_types),
        # a_linears are Sequential[Linear, Dropout]
        "to_out": _stacked_linear(sd, p + ".a_linears.{}.0", n_types),
        "relation_att": sd.take(f"{p}.relation_att"),
        "relation_msg": np.swapaxes(
            sd.take(f"{p}.relation_msg"), -1, -2),
        "rel_pos_bias": sd.take(
            f"{p}.relative_position_bias_table.weight"),
    }


def convert_hetero_fusion(sd: StateDict,
                          prefix: str = "fusion_net") -> dict:
    """Reference HeteroFusion trunk (the H3GAT core of
    bevformer_point_pillar_hetero.py:22-49: one shared
    HeteroFusionBlock iterated num_iters times + mlp_head) ->
    models/hetero_fusion.HeteroFusion variables (the CLI writes them
    into the HeteroFusion of the model of --hypes).

    The reference's ``aggregate_fc`` is constructed but never called in
    ANY forward (sub_modules/hetero_fusion.py:326 is its only
    occurrence) — pure dead weight, consumed-as-dead here.  The
    parallel-architect ``split_attn`` (live in parallel checkpoints,
    hetero_fusion.py:295,468-470) maps onto our SplitAttn_0."""
    blk = f"{prefix}.hetero_fusion_block"
    block_params = {
        "window_norm": _hetero_ln(sd, f"{blk}.window_norm"),
        "window_attn": _hetero_attn(sd, f"{blk}.window_attention"),
        "window_ffn_norm": _hetero_ln(sd, f"{blk}.window_ffd.norm"),
        "window_ffn": _hetero_ffn(sd, f"{blk}.window_ffd.fn"),
        "grid_norm": _hetero_ln(sd, f"{blk}.grid_norm"),
        "grid_attn": _hetero_attn(sd, f"{blk}.grid_attention"),
        "grid_ffn_norm": _hetero_ln(sd, f"{blk}.grid_ffd.norm"),
        "grid_ffn": _hetero_ffn(sd, f"{blk}.grid_ffd.fn"),
    }
    if sd.has(f"{blk}.split_attn.fc1.weight"):
        # parallel architect mode (reference split_attn.py:32-48:
        # bias-less fc1 -> LayerNorm 'bn1' -> bias-less fc2, radix
        # softmax over the two phase branches)
        block_params["SplitAttn_0"] = {
            "fc1": {"kernel": sd.take(f"{blk}.split_attn.fc1.weight").T},
            "bn1": layernorm(sd, f"{blk}.split_attn.bn1"),
            "fc2": {"kernel": sd.take(f"{blk}.split_attn.fc2.weight").T},
        }
    dead = sd.mark_dead([f"{blk}.aggregate_fc"])
    params = {
        "HeteroFusionBlock_0": block_params,
        "mlp_head": _hetero_ffn(sd, f"{prefix}.mlp_head"),
    }
    return {"params": params, "batch_stats": {},
            "dead_reference_keys": dead}


# ---------------------------------------------------------------------
# mmdet ResNet + single-level FPN (the BEVFormer image trunk)
# ---------------------------------------------------------------------
_RESNET_LAYOUT = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
                  "resnet50": (3, 4, 6, 3)}
_RESNET_BOTTLENECK = {"resnet18": False, "resnet34": False,
                      "resnet50": True}


def convert_mmdet_resnet(sd, arch: str = "resnet50") -> tuple[dict, dict]:
    """mmdet/torchvision ResNet state_dict subtree (conv1/bn1/layer{s})
    -> models/resnet.ResNetEncoder (params, batch_stats).  mmdet's
    'pytorch'-style ResNet shares torchvision's exact key layout
    (reference config opencood/hypes_yaml/opcl/subbevformer_resnet.py:
    24-32)."""
    p: dict = {"Conv_0": conv(sd, "conv1")}
    s: dict = {}
    bnp, bns = batchnorm(sd, "bn1")
    p["BatchNorm_0"] = bnp
    s["BatchNorm_0"] = bns
    bottleneck = _RESNET_BOTTLENECK[arch]
    blk_name = "Bottleneck" if bottleneck else "BasicBlock"
    k = 0
    for stage, n_blocks in enumerate(_RESNET_LAYOUT[arch]):
        for j in range(n_blocks):
            base = f"layer{stage + 1}.{j}"
            bp, bs = {}, {}
            n_convs = 3 if bottleneck else 2
            for ci in range(n_convs):
                bp[f"Conv_{ci}"] = conv(sd, f"{base}.conv{ci + 1}")
                bnp, bns = batchnorm(sd, f"{base}.bn{ci + 1}")
                bp[f"BatchNorm_{ci}"] = bnp
                bs[f"BatchNorm_{ci}"] = bns
            if sd.has(f"{base}.downsample.0.weight"):
                bp[f"Conv_{n_convs}"] = conv(sd, f"{base}.downsample.0")
                bnp, bns = batchnorm(sd, f"{base}.downsample.1")
                bp[f"BatchNorm_{n_convs}"] = bnp
                bs[f"BatchNorm_{n_convs}"] = bns
            p[f"{blk_name}_{k}"] = bp
            s[f"{blk_name}_{k}"] = bs
            k += 1
    return p, s


# ---------------------------------------------------------------------
# BEVFormer camera trunk (only_bev path) -> models/bevformer_ref
# ---------------------------------------------------------------------
def convert_bevformer_camera(sd, arch: str = "resnet50") -> dict:
    """Reference mmdet3d-BEVFormer subtree (img_backbone + img_neck +
    pts_bbox_head.{bev_embedding, positional_encoding, transformer
    .encoder/.level_embeds/.cams_embeds}) -> RefBEVFormer variables
    under the ``bevformer`` module name (models/bevformer_ref.py).
    ``sd`` is a prefix view rooted at the wrapper's ``bevformer``
    module (reference bevformer_wrapper.py:15)."""
    p: dict = {}
    s: dict = {}
    bb_p, bb_s = convert_mmdet_resnet(sd.sub("img_backbone"), arch)
    p["backbone"] = bb_p
    s["backbone"] = bb_s
    p["neck_lateral"] = conv(sd, "img_neck.lateral_convs.0.conv")
    p["neck_fpn"] = conv(sd, "img_neck.fpn_convs.0.conv")

    head = sd.sub("pts_bbox_head")
    p["bev_embedding"] = head.take("bev_embedding.weight")
    p["row_embed"] = head.take("positional_encoding.row_embed.weight")
    p["col_embed"] = head.take("positional_encoding.col_embed.weight")
    tr = head.sub("transformer")
    p["level_embeds"] = tr.take("level_embeds")
    p["cams_embeds"] = tr.take("cams_embeds")

    i = 0
    while tr.has(f"encoder.layers.{i}.norms.0.weight"):
        ly = tr.sub(f"encoder.layers.{i}")
        tsa = ly.sub("attentions.0")
        sca = ly.sub("attentions.1")
        p[f"layer{i}"] = {
            "tsa": {
                "sampling_offsets": linear(tsa, "sampling_offsets"),
                "attention_weights": linear(tsa, "attention_weights"),
                "value_proj": linear(tsa, "value_proj"),
                "output_proj": linear(tsa, "output_proj"),
            },
            "sca": {
                "sampling_offsets": linear(
                    sca, "deformable_attention.sampling_offsets"),
                "attention_weights": linear(
                    sca, "deformable_attention.attention_weights"),
                "value_proj": linear(
                    sca, "deformable_attention.value_proj"),
                "output_proj": linear(sca, "output_proj"),
            },
            "norm0": layernorm(ly, "norms.0"),
            "norm1": layernorm(ly, "norms.1"),
            "norm2": layernorm(ly, "norms.2"),
            # mmcv FFN: layers.0 = Sequential(Linear, ReLU, Dropout),
            # layers.1 = Linear
            "ffn_fc1": linear(ly, "ffns.0.layers.0.0"),
            "ffn_fc2": linear(ly, "ffns.0.layers.1"),
        }
        i += 1
    if i == 0:
        raise KeyError("no transformer.encoder.layers.* keys found")
    return {"params": p, "batch_stats": s, "num_layers": i}


# ---------------------------------------------------------------------
# NaiveDecoder / HeteroDecoder -> models/hmvit.HeteroDecoder
# ---------------------------------------------------------------------
def _conv_into_bn(sd, conv_key: str, bn_key: str) -> tuple[dict, dict]:
    """torch [Conv2d(bias=True), BatchNorm2d] -> our bias-free
    ConvBNReLU: the conv bias is folded into the BN running mean
    (normalization output is invariant to a constant pre-BN shift, so
    mean' = mean - bias is exact in both train and eval modes)."""
    cp = {"Conv_0": {"kernel":
                     sd.take(f"{conv_key}.weight").transpose(2, 3, 1, 0)}}
    bias = (sd.take(f"{conv_key}.bias")
            if sd.has(f"{conv_key}.bias") else 0.0)
    bnp, bns = batchnorm(sd, bn_key)
    bns = {"mean": bns["mean"] - bias, "var": bns["var"]}
    cp["BatchNorm_0"] = bnp
    return cp, {"BatchNorm_0": bns}


def convert_naive_decoder(sd, num_layer: int = 2) -> tuple[dict, dict]:
    """Reference NaiveDecoder (ModuleList ``decoder.{k}`` with ReLU
    gaps, naive_decoder.py:36-54) -> our NaiveDecoder
    (ConvBNReLU_{j} pairs)."""
    p, s = {}, {}
    for t in range(num_layer):
        for half in range(2):
            cp, cs = _conv_into_bn(sd, f"decoder.{6 * t + 3 * half}",
                                   f"decoder.{6 * t + 3 * half + 1}")
            p[f"ConvBNReLU_{2 * t + half}"] = cp
            s[f"ConvBNReLU_{2 * t + half}"] = cs
    return p, s


def convert_hetero_decoder(sd, num_layer: int = 2) -> dict:
    """Reference HeteroDecoder (per-modality NaiveDecoder + cls/reg
    heads, sub_modules/hetero_decoder.py:27-40) -> the HeteroDecoder_0
    subtree of HMViT."""
    p, s = {}, {}
    for modality in ("camera", "lidar"):
        dp, ds = convert_naive_decoder(sd.sub(f"{modality}_decoder"),
                                       num_layer)
        p[f"{modality}_decoder"] = dp
        s[f"{modality}_decoder"] = ds
        p[f"{modality}_head"] = {
            "Conv_0": conv(sd, f"{modality}_cls_head"),
            "Conv_1": conv(sd, f"{modality}_reg_head"),
        }
    return {"params": p, "batch_stats": s}


# ---------------------------------------------------------------------
# Full flagship: bevformer_point_pillar_hetero -> one HMViT tree
# ---------------------------------------------------------------------
# reference submodules that exist in the flagship checkpoint but are
# DEAD in its forward: the BEVFormer detection head/decoder (only_bev,
# bevformer_wrapper.py:79), the wrapper's own decoder+heads
# (return_features, bevformer_wrapper.py:85-86), the PointPillar heads
# (return_features, point_pillar.py:53-54), and the top-level cls/reg
# heads shadowed by the HeteroDecoder (bevformer_point_pillar_hetero
# .py:124-129)
_FLAGSHIP_DEAD = [
    "camera_encoder.bevformer.pts_bbox_head.transformer.decoder",
    "camera_encoder.bevformer.pts_bbox_head.transformer"
    ".reference_points",
    "camera_encoder.bevformer.pts_bbox_head.transformer.can_bus_mlp",
    "camera_encoder.bevformer.pts_bbox_head.query_embedding",
    "camera_encoder.bevformer.pts_bbox_head.cls_branches",
    "camera_encoder.bevformer.pts_bbox_head.reg_branches",
    "camera_encoder.bevformer.pts_bbox_head.code_weights",
    "camera_encoder.decoder",
    "camera_encoder.cls_head",
    "camera_encoder.reg_head",
    "camera_encoder.seg_head",
    "lidar_encoder.cls_head",
    "lidar_encoder.reg_head",
    "cls_head",
    "reg_head",
]


def convert_flagship(sd: StateDict, margs: dict) -> dict:
    """Reference ``bevformer_point_pillar_hetero`` state_dict (the
    checkpoint the paper's training run produces,
    opencood/models/bevformer_point_pillar_hetero.py:52-133 saved by
    tools/train_utils.py:26-74) -> ONE HMViT variables tree with
    camera_encoder = the bevformer_ref twin, lidar_encoder =
    PointPillarEncoder, fusion = HeteroFusion, HeteroDecoder_0.

    ``margs`` is the yaml's model.args (lidar backbone shapes +
    hetero_decoder num_layer)."""
    cam = convert_bevformer_camera(
        sd.sub("camera_encoder.bevformer"),
        margs.get("camera", {}).get("backbone", "resnet50"))
    lid_p, lid_s = convert_point_pillar_encoder(
        sd.sub("lidar_encoder"), margs["lidar"])
    fus = convert_hetero_fusion(sd, "fusion_net")
    dec = convert_hetero_decoder(
        sd.sub("decoder"),
        margs.get("hetero_decoder", {}).get("num_layer", 2))

    params = {
        "camera_encoder": {"bevformer": cam["params"]},
        "lidar_encoder": lid_p,
        "fusion": fus["params"],
        "HeteroDecoder_0": dec["params"],
    }
    stats = {
        "camera_encoder": {"bevformer": cam["batch_stats"]},
        "lidar_encoder": lid_s,
        "HeteroDecoder_0": dec["batch_stats"],
    }
    if sd.has("compressor.encoder.0.weight"):
        raise NotImplementedError(
            "compression > 0 checkpoints are not supported yet "
            "(NaiveCompressor subtree)")
    dead = sorted(fus.get("dead_reference_keys", [])
                  + sd.mark_dead(_FLAGSHIP_DEAD))
    return {"params": params, "batch_stats": stats,
            "dead_reference_keys": dead,
            "camera_num_layers": cam["num_layers"]}


def convert_bevformer_wrapper(sd: StateDict, margs: dict) -> dict:
    """Reference standalone ``bevformer_wrapper`` late-fusion camera
    detector (bevformer_wrapper.py:9-94 used as the model itself, keys
    ``bevformer.* / decoder.* / cls_head / reg_head``) ->
    models/bevformer_ref.RefBEVFormerDetector variables."""
    cam = convert_bevformer_camera(
        sd.sub("bevformer"),
        (margs or {}).get("camera", {}).get("backbone", "resnet50"))
    num_layer = ((margs or {}).get("decoder", {})
                 or {}).get("num_layer", 2)
    # wrapper attr 'decoder' holds a NaiveDecoder whose own ModuleList
    # is also named 'decoder' -> keys decoder.decoder.{k}
    dp, ds = convert_naive_decoder(sd.sub("decoder"), num_layer)
    params = {
        "bevformer": cam["params"],
        "decoder": dp,
        "head": {"Conv_0": conv(sd, "cls_head"),
                 "Conv_1": conv(sd, "reg_head")},
    }
    stats = {"bevformer": cam["batch_stats"], "decoder": ds}
    dead = sd.mark_dead([
        "bevformer.pts_bbox_head.transformer.decoder",
        "bevformer.pts_bbox_head.transformer.reference_points",
        "bevformer.pts_bbox_head.transformer.can_bus_mlp",
        "bevformer.pts_bbox_head.query_embedding",
        "bevformer.pts_bbox_head.cls_branches",
        "bevformer.pts_bbox_head.reg_branches",
        "bevformer.pts_bbox_head.code_weights",
    ])
    return {"params": params, "batch_stats": stats,
            "dead_reference_keys": dead,
            "camera_num_layers": cam["num_layers"]}


CONVERTERS = {
    "point_pillar": lambda sd, margs, prefix: convert_point_pillar(sd, margs),
    "fax": lambda sd, margs, prefix: convert_fax_module(sd, prefix or "fax"),
    "cvt": lambda sd, margs, prefix: convert_cvt_module(sd, prefix or "cvm"),
    "hetero_fusion": lambda sd, margs, prefix: convert_hetero_fusion(
        sd, prefix or "fusion_net"),
    "bevformer": lambda sd, margs, prefix: {
        k: v for k, v in convert_bevformer_camera(
            sd.sub(prefix or "camera_encoder.bevformer")).items()
        if k in ("params", "batch_stats")},
    "bevformer_point_pillar_hetero":
        lambda sd, margs, prefix: convert_flagship(sd, margs),
    "bevformer_wrapper":
        lambda sd, margs, prefix: convert_bevformer_wrapper(sd, margs),
}


# ---------------------------------------------------------------------
# REVERSE direction: HMViT variables -> reference-keyed state_dict
# ---------------------------------------------------------------------
# Migration is bidirectional: `export_flagship` emits the reference's
# exact `net_epoch%d.pth` key layout from one HMViT variables tree, so
# weights trained in the port load into the reference with its own
# ``load_saved_model`` (which uses strict=False,
# opencood/tools/train_utils.py:70 — the reference-side dead heads we
# never carry are simply left at their torch init).  Each exporter is
# the literal mirror of its convert_* function; the pairing is pinned
# by the export->convert round trips in
# tests/test_torch_convert_checkpoint.py.

class _Writer:
    """Accumulates a torch-style state_dict (name -> numpy)."""

    def __init__(self):
        self.out: dict[str, np.ndarray] = {}

    def put(self, key: str, value) -> None:
        self.out[key] = np.asarray(value)

    def conv(self, key: str, p: dict) -> None:
        self.put(f"{key}.weight",
                 np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def linear(self, key: str, p: dict) -> None:
        self.put(f"{key}.weight", np.asarray(p["kernel"]).T)
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def layernorm(self, key: str, p: dict) -> None:
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])

    def batchnorm(self, key: str, p: dict, s: dict) -> None:
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])
        self.put(f"{key}.running_mean", s["mean"])
        self.put(f"{key}.running_var", s["var"])

    def conv_transpose(self, key: str, p: dict) -> None:
        w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1,
                                                          ::-1]
        # .copy(), not ascontiguousarray: size-1 kernel axes count as
        # 'contiguous' to numpy, which would keep the flip's negative
        # strides and break torch.from_numpy
        self.put(f"{key}.weight", w.copy())
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def conv_from_bn_fold(self, conv_key: str, bn_key: str, cp: dict,
                          cs: dict) -> None:
        """Mirror of _conv_into_bn: our bias-free conv + BN exports as
        conv bias 0 (the import folded it into the running mean, which
        already carries the shift — functionally identical)."""
        k = np.asarray(cp["Conv_0"]["kernel"])
        self.put(f"{conv_key}.weight", k.transpose(3, 2, 0, 1))
        self.put(f"{conv_key}.bias", np.zeros(k.shape[-1], k.dtype))
        self.batchnorm(bn_key, cp["BatchNorm_0"],
                       cs["BatchNorm_0"])


def _export_stacked_linear(w, fmt: str, p: dict) -> None:
    """Mirror of _stacked_linear: (T, din, dout)+(T, dout) -> per-type
    torch Linears."""
    for t in range(np.asarray(p["kernel"]).shape[0]):
        w.put(fmt.format(t) + ".weight", np.asarray(p["kernel"])[t].T)
        w.put(fmt.format(t) + ".bias", np.asarray(p["bias"])[t])


def _export_hetero_ln(w, key: str, p: dict) -> None:
    for t in range(np.asarray(p["scale"]).shape[0]):
        w.put(f"{key}.net.{t}.weight", np.asarray(p["scale"])[t])
        w.put(f"{key}.net.{t}.bias", np.asarray(p["bias"])[t])


def _export_hetero_ffn(w, key: str, p: dict) -> None:
    _export_stacked_linear(w, key + ".net.{}.0", p["HeteroDense_0"])
    _export_stacked_linear(w, key + ".net.{}.3", p["HeteroDense_1"])


def _export_hetero_attn(w, key: str, p: dict) -> None:
    _export_stacked_linear(w, key + ".q_linears.{}", p["to_q"])
    _export_stacked_linear(w, key + ".k_linears.{}", p["to_k"])
    _export_stacked_linear(w, key + ".v_linears.{}", p["to_v"])
    _export_stacked_linear(w, key + ".a_linears.{}.0", p["to_out"])
    w.put(f"{key}.relation_att", p["relation_att"])
    w.put(f"{key}.relation_msg",
          np.swapaxes(np.asarray(p["relation_msg"]), -1, -2))
    w.put(f"{key}.relative_position_bias_table.weight",
          p["rel_pos_bias"])


def export_hetero_fusion(w, prefix: str, params: dict) -> None:
    blk_key = f"{prefix}.hetero_fusion_block"
    blk = params["HeteroFusionBlock_0"]
    _export_hetero_ln(w, f"{blk_key}.window_norm", blk["window_norm"])
    _export_hetero_attn(w, f"{blk_key}.window_attention",
                        blk["window_attn"])
    _export_hetero_ln(w, f"{blk_key}.window_ffd.norm",
                      blk["window_ffn_norm"])
    _export_hetero_ffn(w, f"{blk_key}.window_ffd.fn",
                       blk["window_ffn"])
    _export_hetero_ln(w, f"{blk_key}.grid_norm", blk["grid_norm"])
    _export_hetero_attn(w, f"{blk_key}.grid_attention",
                        blk["grid_attn"])
    _export_hetero_ln(w, f"{blk_key}.grid_ffd.norm",
                      blk["grid_ffn_norm"])
    _export_hetero_ffn(w, f"{blk_key}.grid_ffd.fn", blk["grid_ffn"])
    if "SplitAttn_0" in blk:
        sa = blk["SplitAttn_0"]
        w.put(f"{blk_key}.split_attn.fc1.weight",
              np.asarray(sa["fc1"]["kernel"]).T)
        w.layernorm(f"{blk_key}.split_attn.bn1", sa["bn1"])
        w.put(f"{blk_key}.split_attn.fc2.weight",
              np.asarray(sa["fc2"]["kernel"]).T)
    _export_hetero_ffn(w, f"{prefix}.mlp_head", params["mlp_head"])


def export_point_pillar_encoder(w, prefix: str, margs: dict,
                                params: dict, stats: dict) -> None:
    pfn_p = params["PillarFeatureNet_0"]
    pfn_s = stats["PillarFeatureNet_0"]
    i = 0
    while f"Dense_{i}" in pfn_p:
        w.linear(f"{prefix}pillar_vfe.pfn_layers.{i}.linear",
                 pfn_p[f"Dense_{i}"])
        w.batchnorm(f"{prefix}pillar_vfe.pfn_layers.{i}.norm",
                    pfn_p[f"MaskedBatchNorm_{i}"],
                    pfn_s[f"MaskedBatchNorm_{i}"])
        i += 1
    bb = margs["base_bev_backbone"]
    bb_p = params["BEVBackbone_0"]
    bb_s = stats["BEVBackbone_0"]
    ci = 0
    n_convT = n_conv = 0
    for si, n_layers in enumerate(bb["layer_nums"]):
        idxs = [1] + [4 + 3 * k for k in range(n_layers)]
        for idx in idxs:
            w.conv(f"{prefix}backbone.blocks.{si}.{idx}",
                   bb_p[f"ConvBNReLU_{ci}"]["Conv_0"])
            w.batchnorm(f"{prefix}backbone.blocks.{si}.{idx + 1}",
                        bb_p[f"ConvBNReLU_{ci}"]["BatchNorm_0"],
                        bb_s[f"ConvBNReLU_{ci}"]["BatchNorm_0"])
            ci += 1
        de = f"{prefix}backbone.deblocks.{si}"
        if bb["upsample_strides"][si] >= 1:
            w.conv_transpose(f"{de}.0", bb_p[f"ConvTranspose_{n_convT}"])
            n_convT += 1
        else:
            w.conv(f"{de}.0", bb_p[f"Conv_{n_conv}"])
            n_conv += 1
        w.batchnorm(f"{de}.1", bb_p[f"BatchNorm_{si}"],
                    bb_s[f"BatchNorm_{si}"])
    if "DownsampleConv_0" in params:
        dc = params["DownsampleConv_0"]
        for li in range(len(margs["shrink_header"]["dim"])):
            base = f"{prefix}shrink_conv.layers.{li}.double_conv"
            w.conv(f"{base}.0", dc[f"DoubleConv_{li}"]["Conv_0"])
            w.conv(f"{base}.2", dc[f"DoubleConv_{li}"]["Conv_1"])


def export_mmdet_resnet(w, prefix: str, params: dict, stats: dict,
                        arch: str = "resnet50") -> None:
    w.conv(f"{prefix}conv1", params["Conv_0"])
    w.batchnorm(f"{prefix}bn1", params["BatchNorm_0"],
                stats["BatchNorm_0"])
    bottleneck = _RESNET_BOTTLENECK[arch]
    blk_name = "Bottleneck" if bottleneck else "BasicBlock"
    n_convs = 3 if bottleneck else 2
    k = 0
    for stage, n_blocks in enumerate(_RESNET_LAYOUT[arch]):
        for j in range(n_blocks):
            base = f"{prefix}layer{stage + 1}.{j}"
            bp = params[f"{blk_name}_{k}"]
            bs = stats[f"{blk_name}_{k}"]
            for ci in range(n_convs):
                w.conv(f"{base}.conv{ci + 1}", bp[f"Conv_{ci}"])
                w.batchnorm(f"{base}.bn{ci + 1}",
                            bp[f"BatchNorm_{ci}"],
                            bs[f"BatchNorm_{ci}"])
            if f"Conv_{n_convs}" in bp:
                w.conv(f"{base}.downsample.0", bp[f"Conv_{n_convs}"])
                w.batchnorm(f"{base}.downsample.1",
                            bp[f"BatchNorm_{n_convs}"],
                            bs[f"BatchNorm_{n_convs}"])
            k += 1


def export_bevformer_camera(w, prefix: str, params: dict, stats: dict,
                            arch: str = "resnet50") -> None:
    export_mmdet_resnet(w, f"{prefix}img_backbone.",
                        params["backbone"], stats["backbone"], arch)
    w.conv(f"{prefix}img_neck.lateral_convs.0.conv",
           params["neck_lateral"])
    w.conv(f"{prefix}img_neck.fpn_convs.0.conv", params["neck_fpn"])
    head = f"{prefix}pts_bbox_head"
    w.put(f"{head}.bev_embedding.weight", params["bev_embedding"])
    w.put(f"{head}.positional_encoding.row_embed.weight",
          params["row_embed"])
    w.put(f"{head}.positional_encoding.col_embed.weight",
          params["col_embed"])
    tr = f"{head}.transformer"
    w.put(f"{tr}.level_embeds", params["level_embeds"])
    w.put(f"{tr}.cams_embeds", params["cams_embeds"])
    i = 0
    while f"layer{i}" in params:
        ly = params[f"layer{i}"]
        base = f"{tr}.encoder.layers.{i}"
        for name, sub in (("attentions.0", ly["tsa"]),):
            for part in ("sampling_offsets", "attention_weights",
                         "value_proj", "output_proj"):
                w.linear(f"{base}.{name}.{part}", sub[part])
        sca = ly["sca"]
        for part in ("sampling_offsets", "attention_weights",
                     "value_proj"):
            w.linear(f"{base}.attentions.1.deformable_attention.{part}",
                     sca[part])
        w.linear(f"{base}.attentions.1.output_proj",
                 sca["output_proj"])
        for ni in range(3):
            w.layernorm(f"{base}.norms.{ni}", ly[f"norm{ni}"])
        w.linear(f"{base}.ffns.0.layers.0.0", ly["ffn_fc1"])
        w.linear(f"{base}.ffns.0.layers.1", ly["ffn_fc2"])
        i += 1


def export_naive_decoder(w, prefix: str, params: dict, stats: dict,
                         num_layer: int = 2) -> None:
    for t in range(num_layer):
        for half in range(2):
            j = 2 * t + half
            w.conv_from_bn_fold(
                f"{prefix}.decoder.{6 * t + 3 * half}",
                f"{prefix}.decoder.{6 * t + 3 * half + 1}",
                params[f"ConvBNReLU_{j}"], stats[f"ConvBNReLU_{j}"])


def export_hetero_decoder(w, prefix: str, params: dict, stats: dict,
                          num_layer: int = 2) -> None:
    for modality in ("camera", "lidar"):
        export_naive_decoder(w, f"{prefix}.{modality}_decoder",
                             params[f"{modality}_decoder"],
                             stats[f"{modality}_decoder"], num_layer)
        w.conv(f"{prefix}.{modality}_cls_head",
               params[f"{modality}_head"]["Conv_0"])
        w.conv(f"{prefix}.{modality}_reg_head",
               params[f"{modality}_head"]["Conv_1"])


def export_flagship(variables: dict, margs: dict) -> dict:
    """One HMViT variables tree -> the reference's
    ``bevformer_point_pillar_hetero`` state_dict (live keys only; the
    reference's loader is strict=False so its dead heads keep their
    torch init)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    w = _Writer()
    export_bevformer_camera(
        w, "camera_encoder.bevformer.",
        params["camera_encoder"]["bevformer"],
        stats.get("camera_encoder", {}).get("bevformer", {}),
        margs.get("camera", {}).get("backbone", "resnet50"))
    export_point_pillar_encoder(
        w, "lidar_encoder.", margs["lidar"],
        params["lidar_encoder"], stats.get("lidar_encoder", {}))
    export_hetero_fusion(w, "fusion_net", params["fusion"])
    export_hetero_decoder(
        w, "decoder", params["HeteroDecoder_0"],
        stats.get("HeteroDecoder_0", {}),
        margs.get("hetero_decoder", {}).get("num_layer", 2))
    return w.out



# ---------------------------------------------------------------------
# checkpoint discovery + CLI
# ---------------------------------------------------------------------
def find_reference_checkpoint(path: str) -> str:
    """A file path is used as-is; a directory is searched for the
    highest ``net_epoch%d.pth``."""
    if os.path.isfile(path):
        return path
    hits = []
    for f in glob.glob(os.path.join(path, "*epoch*.pth")):
        m = re.findall(r".*epoch(\d+).pth", f)
        if m:
            hits.append((int(m[0]), f))
    if not hits:
        raise FileNotFoundError(f"no net_epoch*.pth under {path!r}")
    return max(hits)[1]


def load_torch_state_dict(path: str) -> StateDict:
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(obj, dict):
        raise TypeError(f"{path!r} did not contain a state_dict")
    # some trainers wrap the state_dict one level down
    for key in ("model_state_dict", "state_dict", "model"):
        if key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    return StateDict({k: v.numpy() if hasattr(v, "numpy") else v
                      for k, v in obj.items()})


def convert(path: str, core_method: str, margs: dict | None = None,
            prefix: str | None = None) -> tuple[dict, list[str]]:
    """-> (variables {params, batch_stats} and the extras, unconsumed key
    names)."""
    if core_method not in CONVERTERS:
        raise ValueError(
            f"unsupported core_method {core_method!r}; "
            f"supported: {sorted(CONVERTERS)}")
    sd = load_torch_state_dict(find_reference_checkpoint(path))
    variables = CONVERTERS[core_method](sd, margs or {}, prefix)
    return variables, sd.unused()


# the conversions of a subtree: the class of the module each fills
def _subtree_classes() -> dict:
    from ..models.bevformer_ref import RefBEVFormer
    from ..models.cvt_ref import RefCrossViewModule
    from ..models.fax_ref import RefFAXModule
    from ..models.hetero_fusion import HeteroFusion

    return {"fax": RefFAXModule, "cvt": RefCrossViewModule,
            "hetero_fusion": HeteroFusion, "bevformer": RefBEVFormer}


def target_module(model: torch.nn.Module, core_method: str
                  ) -> tuple[str, torch.nn.Module]:
    """(state_dict prefix, module) that a conversion fills in ``model``:
    the whole model, or for a subtree the one submodule of its class."""
    classes = _subtree_classes()
    if core_method not in classes:
        return "", model
    hits = [(name, m) for name, m in model.named_modules()
            if isinstance(m, classes[core_method])]
    if len(hits) != 1:
        raise ValueError(
            f"--core_method {core_method}: the model of --hypes holds "
            f"{len(hits)} {classes[core_method].__name__} modules, not one")
    return hits[0][0] + ".", hits[0][1]


def port_state_dict(model: torch.nn.Module, core_method: str,
                    variables: dict) -> dict:
    """``model``'s state_dict with the converted flax-named
    ``variables`` in the module the conversion fills (see
    :func:`target_module`)."""
    from ..bridge import flax_to_state_dict

    prefix, module = target_module(model, core_method)
    out = model.state_dict()
    out.update({prefix + k: v for k, v in
                flax_to_state_dict(module, variables).items()})
    return out


def _optimizer(model, params: dict):
    """The optimizer a run directory's training resumes with: the
    hypes' own, else AdamW."""
    from ..train.schedulers import build_optimizer

    if "optimizer" in params and "lr_scheduler" in params:
        return build_optimizer(model, params["optimizer"],
                               params["lr_scheduler"], 1)[0]
    return torch.optim.AdamW(model.parameters())


def main(argv=None):
    from ..bridge import _flatten, state_dict_to_flax
    from ..config import load_config
    from ..models.zoo import build_model
    from ..nn import init_parameters
    from ..train.checkpointing import save_checkpoint, saved_model_state
    from ..train.trainer import create_train_state

    ap = argparse.ArgumentParser(
        "convert a reference torch checkpoint to a checkpoint of the port "
        "(--from_reference) or export a run directory's flagship "
        "checkpoint back to the reference's state_dict format "
        "(--from_run/--to_reference)")
    ap.add_argument("--from_reference", default=None,
                    help="reference run dir (picks the last net_epochN"
                         ".pth) or a .pth file")
    ap.add_argument("--from_run", default=None,
                    help="REVERSE direction: a run dir (or its ckpt dir) "
                         "whose flagship checkpoint is exported to "
                         "--to_reference as a reference-keyed "
                         "net_epochN.pth (loads into the reference via "
                         "its strict=False loader)")
    ap.add_argument("--to_reference", default=None,
                    help="output .pth path for --from_run")
    ap.add_argument("--core_method", required=True,
                    choices=sorted(CONVERTERS))
    ap.add_argument("--hypes", default=None,
                    help="the run directory's yaml: its model block "
                         "builds the model the checkpoint fills, and its "
                         "model.args parameterize the structure-dependent "
                         "mappings")
    ap.add_argument("--prefix", default=None,
                    help="state_dict prefix of the camera subtree "
                         "(fax: 'fax', cvt: 'cvm')")
    ap.add_argument("--output", default=None,
                    help="checkpoint dir (a run directory's ckpt/)")
    args = ap.parse_args(argv)

    params = load_config(args.hypes) if args.hypes else None

    if args.from_run:
        # ---- reverse export: a run's checkpoint -> reference .pth
        if args.core_method != "bevformer_point_pillar_hetero":
            ap.error("--from_run export supports "
                     "bevformer_point_pillar_hetero")
        if not args.to_reference:
            ap.error("--to_reference <out.pth> is required with "
                     "--from_run")
        run = os.path.abspath(args.from_run)
        ckpt_dir = os.path.join(run, "ckpt")
        if not os.path.isdir(ckpt_dir):
            ckpt_dir, run = run, os.path.dirname(run)
        if params is None:
            params = load_config("", model_dir=run)
        model = build_model(params["model"])
        saved = saved_model_state(ckpt_dir)
        if saved is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
        sd_out = export_flagship(state_dict_to_flax(model, saved),
                                 params["model"]["args"])
        torch.save({k: torch.from_numpy(np.array(v))
                    for k, v in sd_out.items()}, args.to_reference)
        report = {"exported_keys": len(sd_out),
                  "output": os.path.abspath(args.to_reference)}
        print(json.dumps(report))
        return report

    if not args.from_reference or not args.output:
        ap.error("--from_reference and --output are required (or use "
                 "--from_run/--to_reference for the reverse export)")
    if params is None:
        ap.error("--hypes is required: its model block builds the model "
                 "the checkpoint fills (and its model.args shape the "
                 "param tree)")
    margs = params["model"]["args"]

    result, unused = convert(args.from_reference, args.core_method,
                             margs, args.prefix)
    extras = {k: v for k, v in result.items()
              if k not in ("params", "batch_stats")}
    variables = {k: v for k, v in result.items()
                 if k in ("params", "batch_stats")}
    model = init_parameters(build_model(params["model"]), 0)
    filled, _ = target_module(model, args.core_method)
    state_dict = port_state_dict(model, args.core_method, variables)
    model.load_state_dict(state_dict)
    save_checkpoint(args.output, 0,
                    create_train_state(model, _optimizer(model, params)))
    n = sum(int(np.prod(np.shape(x)))
            for _, x in _flatten(variables["params"]))
    report = {"converted_params": n,
              "output": os.path.abspath(args.output),
              "unconsumed_keys": unused}
    if extras.get("dead_reference_keys"):
        report["dead_reference_keys"] = extras["dead_reference_keys"]
    if extras.get("camera_num_layers"):
        report["camera_num_layers"] = extras["camera_num_layers"]
    if filled:
        # a subtree: every other parameter keeps its seed-0 draw
        report["filled_module"] = filled.rstrip(".")
        report["seed_initialised_params"] = sum(
            p.numel() for name, p in model.named_parameters()
            if not name.startswith(filled))
    with open(os.path.join(args.output, "conversion_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    if filled:
        print(f"warning: --core_method {args.core_method} filled only "
              f"{report['filled_module']}; the other "
              f"{report['seed_initialised_params']} parameters of the "
              f"checkpoint are the seed-0 random initialisation",
              file=sys.stderr)
    print(json.dumps({"converted_params": n,
                      "unconsumed_key_count": len(unused)}))
    if unused:
        print("unconsumed keys (not part of the converted subtree):")
        for k in unused[:40]:
            print(f"  {k}")
        if len(unused) > 40:
            print(f"  ... and {len(unused) - 40} more")
    return report


if __name__ == "__main__":
    main()
