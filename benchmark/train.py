"""The train runner: the port's training step (``train/trainer.py::
make_train_step``, bf16 compute against fp32 masters with ``half``, remat
as the configuration says, ``torch.optim.AdamW`` as its hypes give it)
stepping back to back over the cell's pool of fleets, each step's request
copied to the card in the step.

Set-up builds ONE state with the benchmark's seeded fp32 weights and
drives it through ``checked_steps`` steps, on distinct rows of the pool,
through the window's own call and feed: the first step's outputs (a
forward hook of the benchmark's), their losses, the first step's
gradient (from AdamW's first moment) and the parameters' change over
them are what the reference is compared with after the window.  The
window continues the same state.  ``train_frames_per_s`` is steps x
fleets a step over the whole window, the device drained at its end.
With ``trace`` a traced stretch of steps follows the window."""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile

from . import compare, generator, trace as tr
from .reference.data.anchors import generate_anchor_grid, generate_labels
from .weights import float_shapes, load, make_weights

TRACED_STEPS = 2


def labels(pool: list, config: dict, device) -> list[dict]:
    """Each request's anchor labels (the reference's label rule), float32
    tensors on ``device``."""
    anchors = generate_anchor_grid(config["anchor_args"])
    t = config["train"]["target_args"]
    out = []
    for req in pool:
        lab = generate_labels(req["object_bbx_center"][0],
                              req["object_bbx_mask"][0], anchors,
                              t["pos_threshold"], t["neg_threshold"])
        out.append({k: torch.as_tensor(lab[k][None], dtype=torch.float32,
                                       device=device)
                    for k in ("pos_equal_one", "neg_equal_one", "targets")})
    return out


def norms(tensors: dict) -> dict:
    """{name: float L2 norm}, read back in one copy."""
    names = sorted(tensors)
    stacked = torch.stack([tensors[n].float().norm() for n in names])
    return dict(zip(names, stacked.cpu().tolist()))


def run(spec: dict, seed: int, seconds: float, trace: bool, t_start: float,
        device) -> dict:
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.serving import batch_to_device
    from hmvit_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )

    config, traffic = spec["config"], spec["traffic"]
    tcfg = config["train"]
    model = HMViT(dict(config["model"], remat=tcfg["remat"])).to(device)
    load(model, make_weights(float_shapes(model), seed, device,
                             torch.float32))
    o = tcfg["optimizer"]
    opt = torch.optim.AdamW(model.parameters(), lr=o["lr"],
                            betas=tuple(o["betas"]), eps=o["eps"],
                            weight_decay=o["weight_decay"])
    step = make_train_step(model, opt, loss_kwargs=tcfg["loss"],
                           half=tcfg["half"])
    state = create_train_state(model, opt)
    pool = generator.make_pool(seed, traffic)
    labs = labels(pool, config, device)
    n = len(pool)

    def one(k):
        return step(state, batch_to_device(pool[k % n], device, False),
                    labs[k % n], seed)

    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    first = {}

    def keep_first(m, args, out):  # the first step's outputs
        if not first:
            first.update({k: v.detach().float().clone()
                          for k, v in out.items()})

    hook = model.register_forward_hook(keep_first)
    losses = []
    for k in range(traffic["checked_steps"]):
        _, parts = one(k)
        losses.append(float(parts["total_loss"]))
        if k == 0:
            hook.remove()
            b1 = o["betas"][0]
            # the gradient as AdamW got it: its first moment / (1 - b1)
            grads = norms({name: opt.state[p].get(
                "exp_avg", torch.zeros_like(p)) / (1.0 - b1)
                for name, p in model.named_parameters()})
    change = norms({k: p.detach() - start[k]
                    for k, p in model.named_parameters()})
    del start
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    k = traffic["checked_steps"]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one(k)
        k += 1
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    steps = k - traffic["checked_steps"]
    fleets = steps * pool[0]["mode"].shape[0]
    result = {"attempted": steps, "failed": 0, "setup_s": setup_s,
              "end_to_end": {"train_frames_per_s": fleets / window_s},
              "stderr": [f"window {window_s:.3f} s, {steps} steps; checked "
                         f"losses {losses}"]}
    ctx = None
    if trace:
        ctx = traced(lambda: one(k))
        ctx["rate"] = steps / window_s
    result["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    del state, step, opt, model
    torch.cuda.empty_cache()
    if ctx is not None:
        ctx["flops"] = reference_step_flops(config, pool, labs, seed, device)
    result["ctx"] = ctx
    result["compared"], notes = compare.train_numbers(
        {"losses": losses, "grads": grads, "change": change,
         "outputs": first}, pool, labs,
        config, seed, device, len(losses))
    result["stderr"] += notes
    return result


def traced(step) -> dict:
    """Two traced stretches of ``TRACED_STEPS`` steps each: the device
    alone (the runtime's calls but no host operations, whose recording
    would slow a step of some 14 000 launches and read as idle time),
    for the busy time, the window, the operations and the idle gaps; then
    host and device, for the device time inside the kernels'
    ``twin_backward:`` ranges."""
    def stretch(acts):
        with profile(activities=acts) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRACED_STEPS):
                step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return tr.Trace(tr.export(prof)), wall

    device, wall = stretch([ProfilerActivity.CUDA])
    ops = device.device
    lo = min(ev["ts"] for ev in ops)
    hi = max(ev["ts"] + ev["dur"] for ev in ops)
    host, _ = stretch([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    return {"kind": "train", "trace": device, "traced_steps": TRACED_STEPS,
            "window_s": wall, "busy_s": tr.busy_us(ops, lo, hi) * 1e-6,
            "ranges": host.launched_inside("twin_backward:"),
            "breakdown": {"device_ops": tr.top_ops(ops),
                          "idle_gaps": tr.idle_gaps(device, lo, hi)},
            "classes": tr.by_class(ops)}


def reference_step_flops(config, pool, labs, seed, device) -> float:
    """FLOPs of one training step on the reference (forward and backward,
    no recompute): ``FlopCounterMode`` plus its copies' formulas for the
    plain warp and window attention's forward, whose einsums it hides."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.ops.opcount import record_kernel_ops
    from .reference.train.losses import point_pillar_loss

    cfg = dict(config["model"], remat=False)
    with compare.strict_fp32():
        ref = compare.reference_model(cfg, seed, device).train()
        counter = FlopCounterMode(display=False)
        with counter, record_kernel_ops() as calls:
            total, _ = point_pillar_loss(
                ref(compare.to_device(pool[0], device)), labs[0],
                **config["train"]["loss"])
            total.backward()
    flops = float(counter.get_total_flops()) + sum(o for _, o in calls)
    del ref
    torch.cuda.empty_cache()
    return flops
