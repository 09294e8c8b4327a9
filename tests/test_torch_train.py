"""The port's training pieces against the JAX package on the CPU:

* the losses vs ``hmvit_tpu.train.losses`` at 1e-6 relative (NaN
  regression targets included) and ``build_loss``;
* the schedules vs optax over 1000 steps at 1e-7 relative (both in
  float64: optax under ``jax.enable_x64``);
* the Pascal IoU, the anchor labels and ``labels_for_batch`` exactly
  equal;
* ``build_optimizer``'s schedule and frozen subtrees inside the train
  step.

The whole model's train step against JAX's is in
``tests/test_torch_train_step.py`` (float32) and
``tests/test_torch_train_half.py`` (bfloat16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.data.anchors import generate_labels as jgenerate_labels
from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
from hmvit_tpu.train import losses as jlosses
from hmvit_tpu.train.schedulers import build_schedule as jbuild_schedule
from hmvit_tpu.train.trainer import labels_for_batch as jlabels_for_batch
from hmvit_tpu.utils.iou import aligned_iou as jaligned_iou
from hmvit_tpu_torch.data.anchors import generate_labels
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.train import losses
from hmvit_tpu_torch.train.schedulers import build_optimizer, build_schedule
from hmvit_tpu_torch.train.trainer import (
    create_train_state,
    labels_for_batch,
    make_eval_step,
    make_forward,
    make_train_step,
)
from hmvit_tpu_torch.utils.iou import aligned_iou
from tiny_cfg import POSTPROCESS_CFG
from torch_parity import close, t, tiny_batch, tiny_flagship_cfg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- losses, schedules, labels ---------------------------------------------

def _loss_inputs(seed=0, b=2, a=2, h=6, w=5):
    rng = np.random.default_rng(seed)
    psm = (2.0 * rng.standard_normal((b, a, h, w))).astype(np.float32)
    rm = rng.standard_normal((b, 7 * a, h, w)).astype(np.float32)
    pos = (rng.random((b, h, w, a)) < 0.1).astype(np.float32)
    neg = ((rng.random((b, h, w, a)) < 0.7) * (1 - pos)).astype(np.float32)
    targets = rng.standard_normal((b, h, w, 7 * a)).astype(np.float32)
    targets[0, 1, 2, 3] = np.nan  # a NaN target counts as no error
    return ({"psm": psm, "rm": rm},
            {"pos_equal_one": pos, "neg_equal_one": neg, "targets": targets})


def _both(out, labels):
    return ({k: t(v) for k, v in out.items()},
            {k: t(v) for k, v in labels.items()})


@pytest.mark.parametrize("name,kwargs", [
    ("point_pillar_loss", {}),
    ("point_pillar_loss", {"cls_weight": 0.5, "reg_weight": 3.0}),
    ("voxel_net_loss", {})])
def test_anchor_losses_match_jax(name, kwargs):
    out, labels = _loss_inputs()
    want_total, want = getattr(jlosses, name)(out, labels, **kwargs)
    got_total, got = getattr(losses, name)(*_both(out, labels), **kwargs)
    assert np.isfinite(float(got_total))
    close(got_total, want_total, 0.0, 1e-6)
    for key in want:
        close(got[key], want[key], 0.0, 1e-6)


def test_pixor_loss_matches_jax():
    rng = np.random.default_rng(1)
    out = {"cls": rng.standard_normal((2, 1, 6, 5)).astype(np.float32),
           "reg": rng.standard_normal((2, 6, 6, 5)).astype(np.float32)}
    label_map = rng.standard_normal((2, 7, 6, 5)).astype(np.float32)
    label_map[:, 0] = rng.random((2, 6, 5)) < 0.2
    for lm in (label_map, np.concatenate([np.zeros_like(label_map[:, :1]),
                                          label_map[:, 1:]], 1)):
        labels = {"label_map": lm}
        want_total, want = jlosses.pixor_loss(out, labels, 2.0, 0.5)
        got_total, got = losses.pixor_loss(*_both(out, labels), 2.0, 0.5)
        close(got_total, want_total, 0.0, 1e-6)
        for key in want:
            close(got[key], want[key], 0.0, 1e-6)


def test_loss_pieces_match_jax():
    rng = np.random.default_rng(2)
    logits = (3 * rng.standard_normal((4, 30, 1))).astype(np.float32)
    tgt = (rng.random((4, 30, 1)) < 0.3).astype(np.float32)
    wts = rng.random((4, 30, 1)).astype(np.float32)
    close(losses.sigmoid_focal_loss(t(logits), t(tgt), t(wts)),
          jlosses.sigmoid_focal_loss(logits, tgt, wts), 0.0, 1e-6)
    pred = rng.standard_normal((4, 30, 7)).astype(np.float32)
    target = (pred + 0.2 * rng.standard_normal((4, 30, 7))).astype(np.float32)
    target[1, 3, 4] = np.nan
    w = rng.random((4, 30)).astype(np.float32)
    close(losses.weighted_smooth_l1(t(pred), t(target), t(w)),
          jlosses.weighted_smooth_l1(pred, target, w), 1e-7, 1e-6)
    for got, want in zip(losses.add_sin_difference(t(pred), t(target)),
                         jlosses.add_sin_difference(pred, target)):
        close(got, want, 1e-7, 1e-6)


@pytest.mark.parametrize("cfg", [
    {"core_method": "point_pillar_loss", "args": {"cls_weight": 2.0,
                                                  "reg": 3.0}},
    {"core_method": "Voxel_Net_Loss"},
    {"core_method": "pixor_loss", "args": {"alpha": 0.5, "beta": 4.0}}])
def test_build_loss_matches_jax(cfg):
    jfn, jkw = jlosses.build_loss(cfg)
    fn, kw = losses.build_loss(cfg)
    assert fn.__name__ == jfn.__name__ and kw == jkw


SCHEDULES = [
    {"core_method": "step", "step_size": 3, "gamma": 0.5},
    {"core_method": "multistep", "step_size": [2, 5], "gamma": 0.3},
    {"core_method": "Exponential", "gamma": 0.98},
    {"core_method": "cosineannealwarm", "warmup_epoches": 2, "epoches": 20,
     "warmup_lr": 2e-5, "lr_min": 5e-6},
    {"core_method": "cosineannealwarm", "epoches": 10},
    {"core_method": "constant"},
]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=lambda c: c["core_method"])
def test_schedules_match_optax(cfg):
    steps = np.arange(1000)
    got = np.array([build_schedule(cfg, 2e-3, 50)(int(s)) for s in steps])
    with jax.enable_x64(True):
        want = np.asarray(jax.vmap(jbuild_schedule(cfg, 2e-3, 50))(
            jnp.asarray(steps, jnp.int64)))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0.0)


def test_unknown_schedule_and_optimizer_raise():
    with pytest.raises(ValueError, match="lr scheduler"):
        build_schedule({"core_method": "warmup_cosine"}, 1e-3, 10)
    with pytest.raises(ValueError, match="optimizer"):
        build_optimizer(torch.nn.Linear(2, 2), {"lr": 1e-3,
                                                "core_method": "lamb"},
                        {}, 10)


def test_aligned_iou_matches_jax():
    rng = np.random.default_rng(3)
    lo = rng.uniform(-10, 10, (50, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0.5, 6, (50, 2))], 1)
    lo = rng.uniform(-10, 10, (7, 2))
    query = np.concatenate([lo, lo + rng.uniform(0.5, 6, (7, 2))], 1)
    for dtype in (np.float32, np.float64):
        got = aligned_iou(boxes.astype(dtype), query.astype(dtype))
        want = jaligned_iou(boxes.astype(dtype), query.astype(dtype), np)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_labels_equal_jax(seed):
    batch, _ = tiny_batch(seed)
    jpp = JPostprocessor(POSTPROCESS_CFG)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    anchors = pp.generate_anchor_box()
    np.testing.assert_array_equal(anchors, jpp.generate_anchor_box())
    want = jgenerate_labels(batch["object_bbx_center"][0],
                            batch["object_bbx_mask"][0], anchors, 0.6, 0.45)
    got = generate_labels(batch["object_bbx_center"][0],
                          batch["object_bbx_mask"][0], anchors, 0.6, 0.45)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    got = labels_for_batch(pp, anchors, batch)
    want = jlabels_for_batch(jpp, anchors, batch)
    for key in want:
        assert got[key].dtype == torch.float32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


def test_schedule_and_frozen_prefixes_in_the_step():
    """``build_optimizer``'s schedule sets the learning rate of each
    update (the first reads step 0); a frozen top-level submodule gets no
    update and no weight decay."""
    model = init_parameters(HMViT(tiny_flagship_cfg()), seed=0)
    opt, schedule = build_optimizer(
        model, {"lr": 1e-3, "core_method": "AdamW",
                "args": {"weight_decay": 1e-2}},
        {"core_method": "multistep", "step_size": [1], "gamma": 0.1}, 1,
        frozen_prefixes=("camera_encoder",))
    frozen = {n: p.detach().clone() for n, p in model.named_parameters()
              if n.startswith("camera_encoder.")}
    step = make_train_step(model, opt, schedule=schedule)
    batch, _ = tiny_batch(2)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    state = create_train_state(model, opt)
    seen = []
    for _ in range(2):
        state, _ = step(state, {k: t(v) for k, v in batch.items()}, labels)
        seen.append(opt.param_groups[0]["lr"])
    assert seen == [1e-3, pytest.approx(1e-4, rel=1e-12)]
    for name, p in model.named_parameters():
        if name in frozen:
            assert torch.equal(p, frozen[name]), name


def test_eval_step_and_forward_run_in_eval_mode():
    model = init_parameters(HMViT(tiny_flagship_cfg()), seed=0).train()
    state = create_train_state(model, torch.optim.SGD(model.parameters(),
                                                      lr=0.0))
    batch, _ = tiny_batch(2)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    tb = {k: t(v) for k, v in batch.items()}
    before = {n: b.clone() for n, b in model.named_buffers()}
    parts = make_eval_step(model)(state, tb, labels)
    assert not model.training
    assert set(parts) == {"conf_loss", "reg_loss", "total_loss"}
    out = make_forward(model)(state, tb)
    assert tuple(out["psm"].shape) == (1, 2, 16, 16)
    assert not out["psm"].requires_grad
    total, _ = losses.point_pillar_loss(out, labels)
    assert torch.equal(parts["total_loss"], total)
    # eval reads the running statistics and leaves them alone
    for n, b in model.named_buffers():
        assert torch.equal(before[n], b), n
