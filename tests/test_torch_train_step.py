"""One and two train steps of the whole tiny flagship (lidar PointPillars
+ ResNet-50/FPN planar BEVFormer, 2 H3GAT iterations, ``drop_out`` 0,
AdamW) against the JAX package on the CPU, weights through
``bridge.py``: the port in float32 against the JAX step in float64
(``jax.enable_x64``), with the JAX step in float32 beside it as the
yardstick of what float32 rounding does here.

* The first step's loss within 1e-5 relative.
* Each parameter's first gradient within 1e-4 of its largest |value|
  or, where JAX's own float32 gradient lies farther than half that from
  the float64 one, within twice JAX's distance.  Train-mode
  BatchNorm makes the ResNet-50 trunk's gradients ill-conditioned: in
  float32 both frameworks land up to half their scale from the float64
  gradient there (``tests/test_torch_train_mode.py`` holds the trunk
  in float64), and what the camera features carry downstream sets the
  distance of most other leaves (the port 2e-4 of scale at most, JAX's
  float32 step farther).
* ``batch_stats`` after each step: by the gradients' rule, floor 1e-6.
* AdamW: the port's two updates equal ``optax.adamw`` applied to the
  port's own gradients (1e-7 absolute + 1e-6 relative: the same float32
  arithmetic in another order).  Params after two whole steps: Adam
  moves an element by about lr per step in the direction of its
  gradient's sign, so an element whose sign float32 rounding decides
  lands up to 2 lr a step from the float64 run, in either framework
  (measured: both 4.0e-3 at lr 1e-3 after two steps); the port's
  largest distance and its share of elements farther than 1e-6 are
  held to twice JAX's float32 ones.  (So the second step starts from
  other params in each run, and its loss and gradients are not compared:
  the port's second loss lies 1.3e-4 from the float64 one, JAX's
  float32 one 4.9e-5; with the camera encoder skipped, in
  ``tests/test_torch_bucketed_train.py``, the two steps compare tightly.)

Weights are the port's seeded initialisation (flax's default
distributions, ``init_parameters``) carried to the flax tree, the
running statistics random (they do not enter a train-mode forward;
their update does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
from hmvit_tpu.train import losses as jlosses
from hmvit_tpu.train.trainer import labels_for_batch as jlabels_for_batch
from hmvit_tpu_torch.bridge import flax_to_state_dict
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.train.trainer import (
    create_train_state,
    labels_for_batch,
    make_train_step,
)
from tiny_cfg import POSTPROCESS_CFG
from torch_parity import adamw_update, bridged, close, flax_tree, \
    held_to_yardstick, jax_adamw_steps, random_variables, t, tiny_batch, \
    tiny_flagship_cfg

LR, WEIGHT_DECAY = 1e-3, 1e-2
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5
FLOOR = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# -- one model, two steps ---------------------------------------------------

@pytest.fixture(scope="module")
def two_steps():
    torch.set_num_threads(1)
    cfg = tiny_flagship_cfg()
    batch, _ = tiny_batch(2)  # three boxes in range: positive anchors
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JHMViT(cfg)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.key(0), b,
                                              train=False), jb)
    variables = {
        "params": flax_tree(init_parameters(HMViT(cfg), seed=0),
                            shapes)["params"],
        "batch_stats": random_variables(shapes)["batch_stats"]}
    jpp = JPostprocessor(POSTPROCESS_CFG)
    jlab = {k: np.asarray(v) for k, v in jlabels_for_batch(
        jpp, jpp.generate_anchor_box(), batch).items()}
    ref = {x64: jax_adamw_steps(jm, variables, batch, jlab, x64, LR, WEIGHT_DECAY)
           for x64 in (True, False)}

    def port_layout(grads, stats, params=None):
        return flax_to_state_dict(HMViT(cfg), {
            "params": grads if params is None else params,
            "batch_stats": stats})

    model = bridged(HMViT(cfg), variables)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.AdamW(model.parameters(), lr=LR,
                            weight_decay=WEIGHT_DECAY)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    tb = {k: t(v) for k, v in batch.items()}
    port = []
    for _ in range(2):
        state, parts = step(state, tb, labels)
        port.append((float(parts["total_loss"]),
                     {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
                     {n: b.detach().clone()
                      for n, b in model.named_buffers()}))
    return dict(cfg=cfg, batch=batch, labels=labels, model=model,
                state=state, start=start, port=port,
                params={n: p.detach().clone()
                        for n, p in model.named_parameters()},
                ref={x64: ([(loss, port_layout(g, s)) for loss, g, s
                            in steps],
                           port_layout(None, steps[-1][2], params))
                     for x64, (steps, params) in ref.items()})


def test_train_step_loss_matches_jax(two_steps):
    loss64 = two_steps["ref"][True][0][0][0]
    loss32 = two_steps["ref"][False][0][0][0]
    loss = two_steps["port"][0][0]
    print(f"loss: port {loss!r}, JAX float64 {loss64!r}, JAX float32 "
          f"{loss32!r}")
    assert abs(loss - loss64) <= LOSS_RTOL * abs(loss64)


def test_train_step_gradients_match_jax(two_steps):
    _, g64 = two_steps["ref"][True][0][0]
    _, g32 = two_steps["ref"][False][0][0]
    grads = two_steps["port"][0][1]
    assert grads.keys() == {k for k in g64 if not k.endswith(
        ("running_mean", "running_var"))}
    worst = held_to_yardstick(grads, g64, g32, GRAD_RTOL)
    print(f"gradients: worst error / bar {worst}")
    assert worst[0] <= 1.0, worst


@pytest.mark.parametrize("i", [0, 1])
def test_train_step_batch_stats_match_jax(two_steps, i):
    _, s64 = two_steps["ref"][True][0][i]
    _, s32 = two_steps["ref"][False][0][i]
    stats = {n: b for n, b in two_steps["port"][i][2].items()
             if n.endswith(("running_mean", "running_var"))}
    assert stats.keys() == {k for k in s64 if k.endswith(
        ("running_mean", "running_var"))}
    worst = held_to_yardstick(stats, s64, s32, 0.0, FLOOR)
    print(f"batch_stats after step {i + 1}: worst error / bar {worst}")
    assert worst[0] <= 1.0, worst


def test_two_adamw_steps_match_jax(two_steps):
    p64, p32 = two_steps["ref"][True][1], two_steps["ref"][False][1]
    got = two_steps["params"]
    dist, share = {}, {}
    for who, params in (("port", got), ("jax", p32)):
        diffs = torch.cat([(params[n].double() - p64[n]).abs().reshape(-1)
                           for n in got])
        dist[who] = float(diffs.max())
        share[who] = float((diffs > FLOOR).double().mean())
    print(f"params after 2 steps: largest distance {dist}, share farther "
          f"than {FLOOR}: {share}")
    assert dist["port"] <= 2.0 * dist["jax"]
    assert share["port"] <= 2.0 * share["jax"]
    assert two_steps["state"].step == 2


def test_adamw_is_optax_adamw(two_steps):
    """optax.adamw on the port's own gradients gives the port's params:
    bias correction, decoupled weight decay (also of the unused FPN
    levels, whose gradient is zero), the step index."""
    names = list(two_steps["start"])

    def flat(tensors):
        return np.concatenate([tensors[n].numpy().reshape(-1)
                               for n in names])

    params = flat(two_steps["start"])
    tx = optax.adamw(LR, weight_decay=WEIGHT_DECAY)
    opt_state = tx.init(params)
    for _, grads, _ in two_steps["port"]:
        params, opt_state = adamw_update(tx, flat(grads), opt_state, params)
    close(flat(two_steps["params"]), params, 1e-7, 1e-6)
    unused = "camera_encoder.fpn.smooth1.weight"
    assert not two_steps["port"][0][1][unused].any()
    close(two_steps["params"][unused],
          two_steps["start"][unused] * (1 - LR * WEIGHT_DECAY) ** 2, 1e-7)
