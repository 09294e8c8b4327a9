"""The detection loss (port of ``hmvit_tpu/train/losses.py``'s
``point_pillar_loss``): the reference's PointPillarLoss, sigmoid focal
classification (alpha 0.25, gamma 2) normalised by the positive count,
weighted smooth-L1 regression (beta 1/9) with the sin-difference angle
encoding, on one process."""
from __future__ import annotations

import torch


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


def point_pillar_loss(output, labels, cls_weight=1.0, reg_weight=2.0):
    """Total detection loss.  output {"psm": (B, A, H, W), "rm":
    (B, 7A, H, W)} logits; labels {"pos_equal_one": (B, H, W, A),
    "targets": (B, H, W, 7A)}.  Returns (total, {"conf_loss",
    "reg_loss", "total_loss"})."""
    psm, rm = output["psm"], output["rm"]
    b = psm.shape[0]
    b_all = b
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
