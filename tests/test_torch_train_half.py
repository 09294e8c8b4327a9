"""The half-precision train step (``half=True``: bfloat16 compute
against float32 master params, the JAX package's ``_to_bf16``) against
the JAX package's on the CPU, at the tiny flagship with ``drop_out`` 0:
the port's half step against JAX's half step, within twice JAX's own
half-vs-float32 spread plus a floor (as
``tests/test_torch_hmvit.py::test_port_bf16_against_jax_fp32`` holds the
port's bfloat16 forward), on the loss, on every parameter's
gradient (the largest error over the leaves, each over its leaf's
largest |float32 gradient|) and on the updated ``batch_stats``.  Also:
the gradients land on the float32 masters as float32, the running
statistics stay float32, and the batch's float32 tensors (poses and
intrinsics included) enter the forward in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
from hmvit_tpu.train.losses import point_pillar_loss as jloss
from hmvit_tpu.train.trainer import _to_bf16
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
from torch_parity import bridged, f64, flax_tree, random_variables, t, \
    tiny_batch, tiny_flagship_cfg, widened_bf16_einsum

SPREAD_FACTOR = 2.0
FLOOR = 1e-3


@pytest.fixture(scope="module")
def runs():
    """One step's (loss, grads, batch_stats) in the port's layout, as
    float64: JAX float32, JAX half, port half."""
    torch.set_num_threads(1)
    cfg = tiny_flagship_cfg()
    batch, _ = tiny_batch(2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JHMViT(cfg)
    shapes = jax.eval_shape(lambda b: jm.init(jax.random.key(0), b,
                                              train=False), jb)
    variables = {
        "params": flax_tree(init_parameters(HMViT(cfg), seed=0),
                            shapes)["params"],
        "batch_stats": random_variables(shapes)["batch_stats"]}
    jpp = JPostprocessor(POSTPROCESS_CFG)
    jl = jlabels_for_batch(jpp, jpp.generate_anchor_box(), batch)

    def jax_step(half):
        def compute(params, bs):
            p = _to_bf16(params) if half else params
            out, upd = jm.apply({"params": p, "batch_stats": bs},
                                _to_bf16(jb) if half else jb, train=True,
                                mutable=["batch_stats"])
            out = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32),
                                         out)
            return jloss(out, jl)[0], upd["batch_stats"]

        with widened_bf16_einsum():
            fn = jax.jit(jax.value_and_grad(compute, has_aux=True)).lower(
                variables["params"], variables["batch_stats"]).compile()
        (loss, stats), grads = fn(variables["params"],
                                  variables["batch_stats"])
        return float(loss), flax_to_state_dict(HMViT(cfg), {
            "params": f64(grads), "batch_stats": f64(stats)})

    out = {"jax_fp32": jax_step(False), "jax_half": jax_step(True)}
    model = bridged(HMViT(cfg), variables)
    opt = torch.optim.SGD(model.parameters(), lr=0.0)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    tb = {k: t(v) for k, v in batch.items()}
    seen = {}

    def record(module, args, kwargs):
        seen.update({k: v.dtype for k, v in args[0].items()})

    hook = model.register_forward_pre_hook(record, with_kwargs=True)
    _, parts = make_train_step(model, opt, half=True)(
        create_train_state(model, opt), tb, labels)
    hook.remove()
    sd = model.state_dict()
    port = {n: p.grad for n, p in model.named_parameters()}
    port.update({n: sd[n] for n in sd if n not in port})
    out["port_half"] = (float(parts["total_loss"]), port)
    out["model"], out["seen"], out["batch"] = model, seen, tb
    return out


def _spreads(runs, names):
    """{run: max over ``names`` of max |run - jax_fp32| / max |jax_fp32|}."""
    ref = runs["jax_fp32"][1]
    out = {}
    for run in ("jax_half", "port_half"):
        got = runs[run][1]
        out[run] = max(float((got[n].double() - ref[n]).abs().max())
                       / max(float(ref[n].abs().max()), 1e-30)
                       for n in names)
    return out


def test_half_loss_within_jax_spread(runs):
    ref = runs["jax_fp32"][0]
    spread = {run: abs(runs[run][0] - ref) / abs(ref)
              for run in ("jax_half", "port_half")}
    bar = SPREAD_FACTOR * spread["jax_half"] + FLOOR
    print(f"loss: spread against JAX float32 {spread}, bar {bar}")
    assert 0 < spread["jax_half"] and spread["port_half"] <= bar


@pytest.mark.parametrize("what", ["gradients", "batch_stats"])
def test_half_step_within_jax_spread(runs, what):
    model = runs["model"]
    if what == "gradients":
        names = [n for n, _ in model.named_parameters()
                 if float(runs["jax_fp32"][1][n].abs().max()) > 0]
    else:
        names = [n for n, _ in model.named_buffers()
                 if n.endswith(("running_mean", "running_var"))]
    spread = _spreads(runs, names)
    bar = SPREAD_FACTOR * spread["jax_half"] + FLOOR
    print(f"{what}: spread against JAX float32 {spread}, bar {bar}")
    assert np.isfinite(spread["port_half"]) and spread["jax_half"] > 0
    assert spread["port_half"] <= bar


def test_half_casts(runs):
    model = runs["model"]
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert all(b.dtype == torch.float32 for n, b in model.named_buffers()
               if n.endswith(("running_mean", "running_var")))
    for key, dtype in runs["seen"].items():
        if runs["batch"][key].dtype == torch.float32:
            assert dtype == torch.bfloat16, key
        else:
            assert dtype == runs["batch"][key].dtype, key
