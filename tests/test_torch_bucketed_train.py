"""The count-bucketed train step (``make_bucketed_train_step``): the
contracts of ``tests/test_bucketed_train.py`` on the port, and two
all-lidar steps against the JAX package's bucketed step.

* Homogeneous fleets (all-lidar, all-camera, no padding): the bucketed
  step gives the run-both step's loss and updated params (1e-6): there
  both normalise each encoder's train-mode BatchNorm over the same rows,
  and the branch a fleet does not use gets zero gradient either way.
* A mixed fleet trains (finite loss over 5 steps) and keeps one step per
  camera count: a fleet with the same count reuses it, another count
  adds one.
* The branch a fleet does not use gets zero gradient, so AdamW only
  decays it: ``p * (1 - lr * wd)`` (the reference's
  ``find_unused_parameters`` contract: grad 0, not None).
* Two steps of the all-lidar fleet (the camera encoder skipped) against
  the JAX bucketed step in float64, the JAX step in float32 beside it
  as the yardstick: the first loss within 1e-5 relative, the second and
  the params and ``batch_stats`` within twice JAX's own float32
  distance from float64 (floor 1e-6 for the statistics).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
from hmvit_tpu.train.trainer import labels_for_batch as jlabels_for_batch
from hmvit_tpu_torch.bridge import flax_to_state_dict
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.train.trainer import (
    create_train_state,
    labels_for_batch,
    make_bucketed_train_step,
    make_train_step,
)
from tiny_cfg import POSTPROCESS_CFG
from torch_parity import bridged, close, flax_tree, held_to_yardstick, \
    jax_adamw_steps, random_variables, t, tiny_batch, tiny_flagship_cfg

LR, WEIGHT_DECAY = 1e-3, 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _setup(modes, seed=3):
    """A fleet of len(modes) agents without padding, its labels, and a
    factory of identical fresh (model, optimizer, state)."""
    n = len(modes)
    batch, _ = tiny_batch(seed, num_agents=n, max_cav=n)
    batch["mode"] = np.asarray([modes], np.int32)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    cfg = tiny_flagship_cfg()

    def fresh():
        model = init_parameters(HMViT(cfg), seed=0)
        opt = torch.optim.AdamW(model.parameters(), lr=LR,
                                weight_decay=WEIGHT_DECAY)
        return model, opt, create_train_state(model, opt)

    return {k: t(v) for k, v in batch.items()}, labels, fresh


@pytest.mark.parametrize("modes", [[1, 1, 1], [0, 0, 0]])
def test_bucketed_matches_run_both_on_homogeneous_fleet(modes):
    batch, labels, fresh = _setup(modes)
    model, opt, state = fresh()
    _, want = make_train_step(model, opt)(state, batch, labels)
    want_params = {n: p.detach().clone()
                   for n, p in model.named_parameters()}
    model, opt, state = fresh()
    step = make_bucketed_train_step(model, opt)
    _, got = step(state, batch, labels)
    assert step.cache_info().currsize == 1
    close(got["total_loss"], want["total_loss"], 0.0, 1e-6)
    for name, p in model.named_parameters():
        close(p, want_params[name], 1e-6, 1e-6)


def test_bucketed_mixed_fleet_trains_and_caches():
    batch, labels, fresh = _setup([1, 0, 1])
    model, opt, state = fresh()
    step = make_bucketed_train_step(model, opt)
    for _ in range(5):
        state, parts = step(state, batch, labels)
        assert np.isfinite(float(parts["total_loss"]))
    assert step.cache_info().currsize == 1 and state.step == 5
    # the same camera count reuses the step, another count adds one
    state, _ = step(state, dict(batch, mode=torch.tensor([[1, 1, 0]])),
                    labels)
    assert step.cache_info().currsize == 1
    state, _ = step(state, dict(batch, mode=torch.tensor([[0, 0, 1]])),
                    labels)
    assert step.cache_info().currsize == 2


def test_bucketed_unused_branch_gets_weight_decay_only():
    batch, labels, fresh = _setup([1, 1, 1])
    model, opt, state = fresh()
    old = {n: p.detach().clone() for n, p in model.named_parameters()
           if n.startswith("camera_encoder.")}
    make_bucketed_train_step(model, opt)(state, batch, labels)
    for name, p in model.named_parameters():
        if name in old:
            assert not p.grad.any(), name
            # decayed toward zero, not frozen, not gradient-updated
            close(p, old[name] * (1 - LR * WEIGHT_DECAY), 1e-7, 1e-5)


def test_two_all_lidar_steps_match_jax():
    batch, _ = tiny_batch(2)
    batch["mode"][:, :4] = 1
    cfg = tiny_flagship_cfg()
    jm = JHMViT(cfg)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.key(0), b,
                                              train=False),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    variables = {
        "params": flax_tree(init_parameters(HMViT(cfg), seed=0),
                            shapes)["params"],
        "batch_stats": random_variables(shapes)["batch_stats"]}
    jpp = JPostprocessor(POSTPROCESS_CFG)
    jlab = {k: np.asarray(v) for k, v in jlabels_for_batch(
        jpp, jpp.generate_anchor_box(), batch).items()}
    ref = {}
    for x64 in (True, False):
        steps, params = jax_adamw_steps(jm, variables, batch, jlab, x64, LR,
                                        WEIGHT_DECAY, camera_bucket=0)
        ref[x64] = ([loss for loss, _, _ in steps], flax_to_state_dict(
            HMViT(cfg), {"params": params, "batch_stats": steps[-1][2]}))

    model = bridged(HMViT(cfg), variables)
    opt = torch.optim.AdamW(model.parameters(), lr=LR,
                            weight_decay=WEIGHT_DECAY)
    step = make_bucketed_train_step(model, opt)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    state = create_train_state(model, opt)
    tb = {k: t(v) for k, v in batch.items()}
    losses = []
    for _ in range(2):
        state, parts = step(state, tb, labels)
        losses.append(float(parts["total_loss"]))
    assert step.cache_info().currsize == 1
    (l64, l64b), (l32, l32b) = ref[True][0], ref[False][0]
    print(f"losses: port {losses}, JAX float64 {[l64, l64b]}, JAX float32 "
          f"{[l32, l32b]}")
    assert abs(losses[0] - l64) <= 1e-5 * abs(l64)
    assert abs(losses[1] - l64b) <= 2.0 * abs(l32b - l64b)
    sd = {n: v for n, v in model.state_dict().items()}
    params = {n: sd[n] for n, _ in model.named_parameters()}
    stats = {n: sd[n] for n in sd if n.endswith(("running_mean",
                                                  "running_var"))}
    dist = {who: max(float((p[n].double() - ref[True][1][n]).abs().max())
                     for n in params)
            for who, p in (("port", params), ("jax", ref[False][1]))}
    print(f"params after 2 steps: largest distance {dist}")
    assert dist["port"] <= 2.0 * dist["jax"]
    worst = held_to_yardstick(stats, ref[True][1], ref[False][1], 0.0, 1e-6)
    print(f"batch_stats after 2 steps: worst error / bar {worst}")
    assert worst[0] <= 1.0, worst
