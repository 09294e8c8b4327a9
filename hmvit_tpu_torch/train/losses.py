"""Detection losses (port of ``hmvit_tpu/train/losses.py``): plain
functions on tensors.

``point_pillar_loss`` is the reference's PointPillarLoss: sigmoid focal
classification (alpha 0.25, gamma 2) normalised by the positive count,
weighted smooth-L1 regression (beta 1/9) with the sin-difference angle
encoding.  ``voxel_net_loss`` and ``pixor_loss`` are the other two
families, and ``seg_loss`` (``models/seg_head.py``) the segmentation one;
``build_loss`` picks one from a hypes loss block.

Under data parallelism (``parallel.collectives.data_parallel``) each
rank's loss is its term of the global loss: every normaliser is the
global one (the batch, the positive counts, the pixels), as GSPMD's
reductions over a batch-sharded axis are, so the train step sums the
ranks' gradients.
"""
from __future__ import annotations

import torch

from ..models.seg_head import seg_loss
from ..parallel.collectives import global_batch, global_mean, global_sum


def sigmoid_focal_loss(logits, targets, weights, alpha=0.25, gamma=2.0):
    """Elementwise focal loss on logits; weights broadcast over classes."""
    pred = 1.0 / (1.0 + torch.exp(-logits))
    alpha_w = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    pt = targets * (1.0 - pred) + (1.0 - targets) * pred
    focal_w = alpha_w * torch.pow(pt, gamma)
    bce = (torch.clamp(logits, min=0) - logits * targets
           + torch.log1p(torch.exp(-torch.abs(logits))))
    return focal_w * bce * weights


def weighted_smooth_l1(pred, target, weights, beta=1.0 / 9.0):
    """Smooth-L1 per element, weighted per row; a NaN target counts as
    a perfect prediction."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = torch.abs(pred - target)
    loss = torch.where(diff < beta, 0.5 * diff ** 2 / beta, diff - 0.5 * beta)
    return loss * weights[..., None]


def add_sin_difference(pred, target, dim=6):
    """Replace the angle channel by the sin(a - b) factorisation:
    sin(a) cos(b) in ``pred``, cos(a) sin(b) in ``target``."""
    a, b = pred[..., dim:dim + 1], target[..., dim:dim + 1]
    sin_enc = torch.sin(a) * torch.cos(b)
    cos_enc = torch.cos(a) * torch.sin(b)
    pred = torch.cat([pred[..., :dim], sin_enc, pred[..., dim + 1:]], dim=-1)
    target = torch.cat([target[..., :dim], cos_enc, target[..., dim + 1:]],
                       dim=-1)
    return pred, target


def voxel_net_loss(output, labels, alpha=1.5, beta=1.0):
    """VoxelNet loss: weighted BCE on the score map + smooth-L1 on the
    positives (the label contract of :func:`point_pillar_loss`)."""
    psm, rm = output["psm"], output["rm"]
    b = psm.shape[0]
    pos = labels["pos_equal_one"].reshape(b, -1)
    neg = labels["neg_equal_one"].reshape(b, -1)
    logits = psm.permute(0, 2, 3, 1).reshape(b, -1)
    prob = 1.0 / (1.0 + torch.exp(-logits))
    eps = 1e-6
    pos_loss = -torch.log(prob + eps) * pos
    neg_loss = -torch.log(1.0 - prob + eps) * neg
    n_pos = torch.clamp(global_sum(pos.sum()), min=1.0)
    n_neg = torch.clamp(global_sum(neg.sum()), min=1.0)
    b_all = global_batch(b)
    conf = (alpha * pos_loss.sum() / n_pos
            + beta * neg_loss.sum() / n_neg) / b_all
    rm_flat = rm.permute(0, 2, 3, 1).reshape(b, -1, 7)
    targets = labels["targets"].reshape(b, -1, 7)
    reg = weighted_smooth_l1(rm_flat, targets, pos / n_pos)
    reg_loss = reg.sum() / b_all
    total = conf + reg_loss
    return total, {"conf_loss": conf, "reg_loss": reg_loss,
                   "total_loss": total}


def pixor_loss(output, labels, alpha=1.0, beta=1.0):
    """Anchor-free PIXOR loss: mean BCE with logits over the objectness
    map plus positive-masked smooth-L1 over the 6-channel regression map,
    normalised by the positive-cell count.  output {"cls": (B, 1, H, W),
    "reg": (B, 6, H, W)}; labels {"label_map": (B, 7, H, W)}."""
    label_map = labels["label_map"]
    cls_t, loc_t = label_map[:, :1], label_map[:, 1:]
    z, loc_p = output["cls"], output["reg"]
    bce = (torch.clamp(z, min=0.0) - z * cls_t
           + torch.log1p(torch.exp(-torch.abs(z))))
    cls_loss = global_mean(bce)
    pos = global_sum(cls_t.sum())
    ad = torch.abs(cls_t * (loc_p - loc_t))
    sl1 = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum()
    reg_loss = torch.where(pos > 0, sl1 / torch.clamp(pos, min=1.0), sl1)
    total = alpha * cls_loss + beta * reg_loss
    return total, {"conf_loss": cls_loss, "reg_loss": reg_loss,
                   "total_loss": total}


def point_pillar_loss(output, labels, cls_weight=1.0, reg_weight=2.0):
    """Total detection loss.  output {"psm": (B, A, H, W), "rm":
    (B, 7A, H, W)} logits; labels {"pos_equal_one": (B, H, W, A),
    "targets": (B, H, W, 7A)}.  Returns (total, {"conf_loss",
    "reg_loss", "total_loss"})."""
    psm, rm = output["psm"], output["rm"]
    b = psm.shape[0]
    b_all = global_batch(b)
    cls_labels = labels["pos_equal_one"].reshape(b, -1)
    positives = cls_labels > 0
    pos_normalizer = torch.clamp(positives.sum(dim=1, keepdim=True),
                                 min=1.0).to(torch.float32)
    cls_weights = torch.ones_like(cls_labels) / pos_normalizer
    reg_weights = positives.to(torch.float32) / pos_normalizer
    cls_preds = psm.permute(0, 2, 3, 1).reshape(b, -1, 1)
    conf = sigmoid_focal_loss(cls_preds, cls_labels[..., None],
                              cls_weights[..., None])
    conf_loss = conf.sum() / b_all * cls_weight
    rm_flat = rm.permute(0, 2, 3, 1).reshape(b, -1, 7)
    targets = labels["targets"].reshape(b, -1, 7)
    rm_sin, tgt_sin = add_sin_difference(rm_flat, targets)
    reg = weighted_smooth_l1(rm_sin, tgt_sin, reg_weights)
    reg_loss = reg.sum() / b_all * reg_weight
    total = conf_loss + reg_loss
    return total, {"conf_loss": conf_loss, "reg_loss": reg_loss,
                   "total_loss": total}


LOSS_REGISTRY = {
    "point_pillar_loss": point_pillar_loss,
    "voxel_net_loss": voxel_net_loss,
    "pixor_loss": pixor_loss,
    "seg_loss": seg_loss,
    "vanilla_seg_loss": seg_loss,
}
# the BEV segmentation losses (trained on map labels, not boxes)
SEG_LOSSES = ("seg_loss", "vanilla_seg_loss")


def build_loss(loss_cfg: dict):
    """(loss function, its keyword arguments) from a hypes loss block.
    The JAX package's ``build_loss`` knows the detection losses; its
    ``tools/train.py`` picks ``seg_loss`` (with ``d_weights`` /
    ``s_weights``) for the two segmentation names, here found in one
    place."""
    name = loss_cfg.get("core_method", "point_pillar_loss").lower()
    fn = LOSS_REGISTRY[name]
    args = loss_cfg.get("args", {})
    if name in SEG_LOSSES:
        kwargs = {"d_weights": float(args.get("d_weights", 75.0)),
                  "s_weights": float(args.get("s_weights", 15.0))}
    elif name == "point_pillar_loss":
        kwargs = {"cls_weight": float(args.get("cls_weight", 1.0)),
                  "reg_weight": float(args.get("reg", 2.0))}
    elif name == "pixor_loss":
        kwargs = {"alpha": float(args.get("alpha", 1.0)),
                  "beta": float(args.get("beta", 1.0))}
    else:
        kwargs = {}
    return fn, kwargs
