"""P3, the bf16 bar on trained weights, on the CPU: the port's accuracy
gate at its shrunk test shapes (``prod_overfit --cpu``, ``SHRUNK`` as in
``tests/test_torch_prod_overfit.py``), its weights carried to flax
(``torch_parity.flax_tree``), and on each fixture frame, with the frame's
serving hints, four readings of max |sigmoid(psm) difference| and of
max |rm difference| over max(1, max |rm|):

* ``jax_bf16_vs_jax_fp32``: the JAX package's own bf16 spread;
* ``port_bf16_vs_port_fp32``: the port's own;
* ``port_bf16_vs_jax_fp32``: what the north star's bar compares;
* ``port_fp32_vs_jax_fp32``: the float32 parity under them.

The bf16 forwards are ``serving_config(..., bf16=True)`` (every layer in
bf16, the bf16 server's casts), the fp32 ones ``bf16=False``.  Run as a
script to read them on a trained gate (several minutes on one core):

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bf16_trained.py \\
        --max_steps 400 --eval_every 50 --target_metric ap50 --target 0.01

(any ``prod_overfit`` flag; one JSON line a frame).  The test runs the
same machinery on the gate's weights after 2 steps.
"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu_torch import prod_overfit
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.serving import GEOMETRY_KEYS, serving_config, \
    serving_hints
from torch_parity import flax_tree, widened_bf16_einsum

SHRUNK = ["--grid", "64", "--image_size", "64", "--num_cavs", "2",
          "--max_points", "4096"]
PAIRS = (("jax_bf16", "jax_fp32"), ("port_bf16", "port_fp32"),
         ("port_bf16", "jax_fp32"), ("port_fp32", "jax_fp32"))


def _to_bf16(x):
    return x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x


def three_spreads(argv) -> list:
    """Train the shrunk gate with ``argv`` and read the spreads (module
    docstring) on its fixture frames: one dict a frame."""
    res = prod_overfit.run(SHRUNK + ["--cpu"] + list(argv))
    cfg = dict(res["cfg"], remat=False)
    cfgs = {"fp32": serving_config(cfg, bf16=False),
            "bf16": serving_config(cfg, bf16=True)}
    weights = res["state"].model.eval().state_dict()
    first = {k: jnp.asarray(v.numpy()) for k, v in res["batches"][0].items()}
    shapes = jax.eval_shape(lambda b: JHMViT(cfgs["fp32"]).init(
        jax.random.key(0), b, train=False), first)
    tree = flax_tree(res["state"].model, shapes)
    ports = {}
    for kind, c in cfgs.items():
        m = HMViT(c)
        m.load_state_dict(weights)
        ports[kind] = (m.to(torch.bfloat16) if kind == "bf16" else m).eval()
    rows = []
    for i, b in enumerate(res["batches"]):
        host = {k: v.numpy() for k, v in b.items()}
        hints = serving_hints(host["mode"][0], int(host["agent_mask"][0]
                                                   .sum()))
        j32 = {k: jnp.asarray(v) for k, v in host.items()}
        j16 = {k: (v if k in GEOMETRY_KEYS else _to_bf16(v))
               for k, v in j32.items()}
        t16 = {k: (v.to(torch.bfloat16) if v.dtype == torch.float32
                   and k not in GEOMETRY_KEYS else v) for k, v in b.items()}
        outs = {"jax_fp32": JHMViT(cfgs["fp32"]).apply(
            tree, j32, train=False, **hints)}
        with widened_bf16_einsum():
            outs["jax_bf16"] = JHMViT(cfgs["bf16"]).apply(
                jax.tree_util.tree_map(_to_bf16, tree), j16, train=False,
                **hints)
        with torch.no_grad():
            outs["port_fp32"] = ports["fp32"](b, **hints)
            outs["port_bf16"] = ports["bf16"](t16, **hints)
        host_out = {}
        for name, out in outs.items():
            host_out[name] = {k: (out[k].float().numpy()
                                  if isinstance(out[k], torch.Tensor)
                                  else np.asarray(out[k], np.float32))
                              for k in ("psm", "rm")}
        ref = host_out["jax_fp32"]
        scores = 1.0 / (1.0 + np.exp(-ref["psm"]))
        row = {"frame": i, "max_sigmoid_fp32": float(scores.max()),
               "anchors_over_0.27": int((scores > 0.27).sum()),
               "hints": {k: (list(v) if isinstance(v, tuple) else v)
                         for k, v in hints.items()}}
        rm_scale = max(1.0, float(np.abs(ref["rm"]).max()))
        for a, c in PAIRS:
            sa = 1.0 / (1.0 + np.exp(-host_out[a]["psm"]))
            sc = 1.0 / (1.0 + np.exp(-host_out[c]["psm"]))
            row[f"{a}_vs_{c}"] = {
                "sigmoid_psm": float(np.abs(sa - sc).max()),
                "rm_over_scale": float(np.abs(host_out[a]["rm"]
                                              - host_out[c]["rm"]).max())
                / rm_scale}
        rows.append(row)
    return rows, res["summary"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_three_spreads_machinery(tmp_path):
    """The readings on the gate's weights after 2 steps (float32
    training), one frame: every spread finite, the float32 parity tight
    (the model's 1e-4 on scores) and each bf16 spread over it."""
    rows, summary = three_spreads([
        "--max_steps", "2", "--eval_every", "2", "--target", "2.0",
        "--fp32", "--log", str(tmp_path / "po.jsonl")])
    assert summary["device"] == "cpu" and len(rows) == 2
    for row in rows:
        parity = row["port_fp32_vs_jax_fp32"]["sigmoid_psm"]
        assert parity <= 1e-4, row
        for a, c in PAIRS[:3]:
            got = row[f"{a}_vs_{c}"]
            assert np.isfinite(got["sigmoid_psm"]) and \
                np.isfinite(got["rm_over_scale"]), row
            assert got["sigmoid_psm"] > parity, row


if __name__ == "__main__":
    readings, gate = three_spreads(sys.argv[1:])
    print(json.dumps({"gate": gate}))
    for r in readings:
        print(json.dumps(r))
