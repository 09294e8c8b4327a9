"""The comparison that decides ``correct``: the benchmark's reference
(``benchmark/reference/``, a frozen float32 copy of the port's plain
path) on the same seeded weights and requests as the program, run after
the window in float32 with TF32 off, against what the program's timed
path produced; and the control, the same reference computed in float8
(a scale a tensor: e4m3 for every matrix product's and convolution's
operands and every leaf module's output, e5m2 for every gradient that
flows back through them), the precision below the served and trained
bfloat16."""
from __future__ import annotations

import contextlib
import copy

import numpy as np
import torch

from .reference.data.anchors import generate_anchor_grid
from .reference.models.hmvit import HMViT
from .reference.postprocess import decode_detections_device
from .weights import float_shapes, load, make_weights

MATMUL_MODULES = ("Dense", "Conv", "ConvTranspose", "Conv3D", "HeteroDense")
E4M3_MAX, E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def reference_config(model_cfg: dict) -> dict:
    """The configuration with every ``compute_dtype`` float32."""
    cfg = copy.deepcopy(model_cfg)

    def walk(d):
        for k, v in d.items():
            if k == "compute_dtype":
                d[k] = "float32"
            elif isinstance(v, dict):
                walk(v)
    walk(cfg)
    return cfg


def reference_model(model_cfg: dict, seed: int, device,
                    weight_dtype=torch.float32) -> HMViT:
    """The reference in float32 holding the benchmark's weights of
    ``seed`` as the program got them (made in ``weight_dtype``, then
    widened)."""
    model = HMViT(reference_config(model_cfg)).to(device)
    w = make_weights(float_shapes(model), seed, device, weight_dtype)
    return load(model, {k: v.float() for k, v in w.items()})


def to_device(request: dict, device, rounded=()) -> dict:
    """A numpy request on ``device``; the float32 arrays named in
    ``rounded`` rounded to bfloat16 (and widened again), as the program
    takes them."""
    out = {}
    for k, v in request.items():
        t = torch.from_numpy(np.asarray(v)).to(device)
        if k in rounded and t.dtype == torch.float32:
            t = t.to(torch.bfloat16).float()
        out[k] = t
    return out


def rounded_inputs(request: dict, keep: list) -> tuple:
    """The float32 inputs of ``request`` the program takes in bfloat16:
    all but those ``keep`` names."""
    return tuple(k for k, v in request.items()
                 if np.asarray(v).dtype == np.float32 and k not in keep)


def hints(traffic: dict) -> dict:
    """The static serving hints of the traffic's fleet: its agents'
    modalities (the ego first), their camera count, batch 1."""
    modes = tuple(int(m) for m in traffic["modes"])
    return dict(camera_bucket=sum(m == 0 for m in modes),
                active_agents=len(modes), static_ego_modality=modes[0],
                static_modes=modes)


def _round8(x, dtype, top: float):
    """``x`` rounded to the float8 ``dtype`` under one scale that maps
    its largest magnitude to ``top``, and widened again."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = (amax / top).to(x.dtype)
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Float8(torch.autograd.Function):
    """e4m3 forward, the incoming gradient e5m2 backward: what float8
    training stores of an activation and of its gradient."""

    @staticmethod
    def forward(ctx, x):
        return _round8(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, grad):
        return _round8(grad, torch.float8_e5m2, E5M2_MAX)


def _fp8(x):
    return _Float8.apply(x)


class _FP8(torch.nn.Module):
    def forward(self, x):
        return _fp8(x)


def _fp8_out(m, args, out):
    if torch.is_tensor(out):
        return _fp8(out) if out.is_floating_point() else out
    if isinstance(out, tuple):
        return tuple(_fp8_out(m, args, o) for o in out)
    return out


def fp8_control(model: torch.nn.Module) -> torch.nn.Module:
    """The model computed in float8 (a per-tensor scale): the operands of
    every matrix product and convolution module (its weights by a
    parametrization, and its input) and every leaf module's output
    rounded to e4m3 at each use, and the gradient flowing back through
    each of them rounded to e5m2, so that the weights' gradients the
    optimizer gets are float8 ones too."""
    from torch.nn.utils import parametrize

    for module in list(model.modules()):
        if type(module).__name__ in MATMUL_MODULES:
            for name, p in list(module.named_parameters(recurse=False)):
                if p.dim() >= 2:
                    parametrize.register_parametrization(module, name,
                                                         _FP8())
            module.register_forward_pre_hook(
                lambda m, args: (_fp8(args[0]), *args[1:]))
        if not any(True for _ in module.children()) or \
                type(module).__name__ in MATMUL_MODULES:
            module.register_forward_hook(_fp8_out)
    return model


def leaf_name(name: str) -> str:
    """A parameter's name without the control's parametrization."""
    return name.replace("parametrizations.", "").replace(".original", "")


def kept_boxes(corners, scores, valid):
    """The kept boxes of one frame as (corners, scores) numpy, in a fixed
    order (score, then corner coordinates), so that two kept sets compare
    whatever the order of tied scores."""
    v = valid.cpu().numpy().astype(bool)
    c = corners.float().cpu().numpy()[v].reshape(int(v.sum()), 24)
    s = scores.float().cpu().numpy()[v]
    order = np.lexsort((*c.T[::-1], -s)) if len(s) else np.arange(0)
    return c[order], s[order]


def box_gap(a, b) -> float:
    """The widest gap, in metres or score, between two kept sets; 1e9
    when they keep different numbers of boxes."""
    (ca, sa), (cb, sb) = a, b
    if len(sa) != len(sb):
        return 1e9
    if not len(sa):
        return 0.0
    return float(max(np.abs(ca - cb).max(), np.abs(sa - sb).max()))


def output_gaps(psm, rm, ref) -> tuple[float, float]:
    """(the widest gap of sigmoid(psm), the widest gap of rm over the
    reference's widest |rm|) of one frame."""
    p = torch.sigmoid(psm.float()) - torch.sigmoid(ref["psm"].float())
    r = (rm.float() - ref["rm"].float()).abs().max() / \
        ref["rm"].float().abs().max()
    return float(p.abs().max()), float(r)


def serve_numbers(samples, pool, config: dict, traffic: dict, seed: int,
                  device, control: bool = False) -> dict:
    """The compared numbers of a serve cell: over the sampled timed frames
    ``samples`` ([(pool index, psm, rm, corners, scores, valid)], the
    program's), the widest ``psm_gap`` and ``rm_gap`` against the
    reference's forward, and the widest ``box_gap`` of the program's
    kept boxes against the reference's decode + NMS of the program's own
    ``psm`` / ``rm`` (so decode + NMS is judged by itself).  With
    ``control`` the reference in float8 stands in the program's place."""
    with strict_fp32(), torch.no_grad():
        ref = reference_model(config["model"], seed, device,
                              torch.bfloat16)
        anchors = torch.as_tensor(
            generate_anchor_grid(config["anchor_args"], "hwl"),
            dtype=torch.float32, device=device)
        eye = torch.eye(4, device=device)
        dec = config["decode"]
        low = (fp8_control(reference_model(config["model"], seed, device,
                                           torch.bfloat16))
               if control else None)
        h = hints(traffic)
        rounded = rounded_inputs(pool[0], config["serve_fp32_inputs"])
        gaps = {"psm_gap": 0.0, "rm_gap": 0.0, "box_gap": 0.0}
        for index, psm, rm, corners, scores, valid in samples:
            req = to_device(pool[index], device, rounded)
            want = ref(req, **h)
            if low is not None:
                got = low(req, **h)
                psm, rm = got["psm"], got["rm"]
                corners, scores, valid = decode_detections_device(
                    psm, rm, anchors, eye, dec["score_threshold"],
                    dec["nms_threshold"])
            p, r = output_gaps(psm, rm, want)
            check = decode_detections_device(psm, rm, anchors, eye,
                                             dec["score_threshold"],
                                             dec["nms_threshold"])
            b = box_gap(kept_boxes(corners, scores, valid),
                        kept_boxes(*check))
            gaps = {"psm_gap": max(gaps["psm_gap"], p),
                    "rm_gap": max(gaps["rm_gap"], r),
                    "box_gap": max(gaps["box_gap"], b)}
    return gaps


def follow(model, pool, labels, config: dict, steps: int, device,
           perturb: float = 0.0) -> dict:
    """The first ``steps`` training steps of ``model`` (float32, AdamW
    written out) on the rows ``pool[:steps]`` and their labels: each
    step's loss, the first gradient's norms, the first step's outputs,
    and the parameters' change (``deltas``, and ``change``: its norms).
    ``perturb`` scales each row's images and point intensities by ``1 +
    perturb * z`` (z normal, fixed), a perturbation of the inputs far
    under the rounding the program's bfloat16 gives them."""
    from .reference.train.losses import point_pillar_loss

    tcfg, o = config["train"], config["train"]["optimizer"]
    b1, b2 = o["betas"]
    # ``half``: every float32 input in bfloat16
    rounded = rounded_inputs(pool[0], []) if tcfg["half"] else ()
    gen = torch.Generator(device=device).manual_seed(1)
    model.train()
    params = {leaf_name(k): p for k, p in model.named_parameters()}
    start = {k: p.detach().clone() for k, p in params.items()}
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    losses, grads, outputs = [], None, None
    for t in range(1, steps + 1):
        model.zero_grad(set_to_none=True)
        req = to_device(pool[t - 1], device, rounded)
        if perturb:
            for key in ("camera", "points"):
                x = req[key].clone()
                part = x[..., -1:] if key == "points" else x
                part.mul_(1 + perturb * torch.randn(
                    part.shape, generator=gen, device=device))
                req[key] = x
        out = model(req)
        total, _ = point_pillar_loss(out, labels[t - 1], **tcfg["loss"])
        total.backward()
        losses.append(float(total.detach()))
        with torch.no_grad():
            if t == 1:
                outputs = {k: x.detach().float() for k, x in out.items()}
            g = {k: (p.grad if p.grad is not None
                     else torch.zeros_like(p)) for k, p in params.items()}
            if t == 1:
                grads = {k: float(x.norm()) for k, x in g.items()}
            for k, p in params.items():
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                p.mul_(1 - o["lr"] * o["weight_decay"])
                denom = (v[k] / (1 - b2 ** t)).sqrt_().add_(o["eps"])
                p.addcdiv_(m[k], denom, value=-o["lr"] / (1 - b1 ** t))
    with torch.no_grad():
        deltas = {k: p.detach() - start[k] for k, p in params.items()}
    return {"losses": losses, "grads": grads, "outputs": outputs,
            "deltas": deltas,
            "change": {k: float(d.norm()) for k, d in deltas.items()}}


def train_numbers(prog: dict, pool, labels, config: dict, seed: int, device,
                  steps: int, control: bool = False) -> tuple[dict, list]:
    """The compared numbers of a train cell: the reference (float32, TF32
    off, AdamW written out) follows the program's first ``steps`` steps
    from the same weights on the same rows and labels.

    ``psm_mean_gap``: the mean gap of sigmoid(psm) over the first step's
    output map (train mode); ``rm_l2_gap``: the relative L2 gap of its
    ``rm`` (a train-mode forward of random weights is ill-conditioned in
    places, so its widest gap is no measure of precision; the mean and
    the L2 are); ``loss_gap``: the first step's loss, relative;
    ``grad_gap``: the first gradient's norms, the median leaf's gap;
    ``update_gap``: the norms of the parameters' change over the steps,
    the median leaf's gap; both leave out the leaves whose reference
    gradient is under a thousandth of the median leaf's (round-off moves
    them under Adam, and a leaf no loss reaches, as the ResNet stages
    after the picked one, would read a gap of 0).  A leaf's gap is taken against the reference's norm
    of that leaf or of the median leaf, whichever is larger.  The worst
    leaves (also against their own norm) and the later steps' losses are
    read and reported, not compared: the reference reads its own worst
    leaves as far off under a perturbation of its inputs a million times
    under bfloat16's rounding (:func:`witness`, PERF.md).  With
    ``control`` the reference in float8 stands in the program's place.
    Returns (the numbers, lines of what was read)."""
    cfg = dict(config["model"], remat=config["train"]["remat"])
    with strict_fp32():
        ref = follow(reference_model(cfg, seed, device), pool, labels,
                     config, steps, device)
        if control:
            prog = follow(fp8_control(reference_model(cfg, seed, device)),
                          pool, labels, config, steps, device)
    names = sorted(ref["grads"])
    moved = moved_leaves(ref["grads"])
    g, g_leaf = leaf_gaps(prog["grads"], ref["grads"], moved)
    u, u_leaf = leaf_gaps(prog["change"], ref["change"], moved)
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    po, ro = prog["outputs"], ref["outputs"]
    sig = (torch.sigmoid(po["psm"]) - torch.sigmoid(ro["psm"])).abs()
    psm_max, _ = output_gaps(po["psm"], po["rm"], ro)
    notes = [f"first step's outputs: widest sigmoid gap {psm_max!r}, psm "
             f"relative L2 {_rel_l2(po['psm'], ro['psm'])!r}",
             f"losses: program {prog['losses']}, reference {ref['losses']}, "
             f"gaps {losses}",
             f"grad leaf gaps: median {np.median(g)!r}, p90 "
             f"{np.quantile(g, 0.9)!r}, worst {g.max()!r} at {g_leaf}",
             f"update leaf gaps: median {np.median(u)!r}, p90 "
             f"{np.quantile(u, 0.9)!r}, worst {u.max()!r} at {u_leaf}; "
             f"{len(names) - len(moved)} leaves left out",
             "worst leaves against their own norm: "
             + worst_own(prog["grads"], ref["grads"], moved, "grad") + "; "
             + worst_own(prog["change"], ref["change"], moved, "update")]
    return {"psm_mean_gap": float(sig.mean()),
            "rm_l2_gap": _rel_l2(po["rm"], ro["rm"]), "loss_gap": losses[0],
            "grad_gap": float(np.median(g)),
            "update_gap": float(np.median(u))}, notes


def moved_leaves(grads: dict) -> list:
    """The leaves whose first gradient is at least a thousandth of the
    median leaf's (of those with any), sorted."""
    median = float(np.median([x for x in grads.values() if x > 0]))
    return sorted(n for n, x in grads.items() if x >= 1e-3 * median)


def worst_own(prog: dict, ref: dict, names, what: str) -> str:
    """The worst leaf's gap of norms against its own reference norm, and
    the absolute gap, as a line."""
    own = np.array([abs(prog[n] - ref[n]) / max(ref[n], 1e-30)
                    for n in names])
    i = int(np.argmax(own))
    return (f"{what} median {np.median(own)!r}, worst {own[i]!r} at "
            f"{names[i]} (norm {ref[names[i]]!r}, gap "
            f"{abs(prog[names[i]] - ref[names[i]])!r})")


def witness(pool, labels, config: dict, seed: int, device, steps: int,
            perturb: float = 1e-6) -> tuple[dict, list]:
    """The reference against itself: its ``steps`` training steps as they
    are, and again on inputs perturbed by ``perturb`` (:func:`follow`),
    read by the train cell's numbers as the program is.  Also, for the
    worst leaf of the change, the share of its elements whose change
    differs in sign between the two, and its first gradient's norm over
    the median leaf's.  Returns (the numbers, lines)."""
    cfg = dict(config["model"], remat=config["train"]["remat"])
    with strict_fp32():
        a = follow(reference_model(cfg, seed, device), pool, labels,
                   config, steps, device)
        b = follow(reference_model(cfg, seed, device), pool, labels,
                   config, steps, device, perturb=perturb)
    moved = moved_leaves(a["grads"])
    g, g_leaf = leaf_gaps(b["grads"], a["grads"], moved)
    u, u_leaf = leaf_gaps(b["change"], a["change"], moved)
    own = {n: abs(b["change"][n] - a["change"][n]) / max(a["change"][n],
                                                         1e-30)
           for n in moved}
    worst = max(own, key=own.get)
    flips = float((torch.sign(a["deltas"][worst])
                   != torch.sign(b["deltas"][worst])).float().mean())
    median = float(np.median([x for x in a["grads"].values() if x > 0]))
    numbers = {"loss_gap": abs(b["losses"][0] - a["losses"][0])
               / abs(a["losses"][0]),
               "grad_gap": float(np.median(g)),
               "update_gap": float(np.median(u)),
               "worst_grad_gap": float(g.max()),
               "worst_update_gap": float(u.max()),
               "worst_update_gap_own": own[worst]}
    notes = [f"grad leaf gaps: worst {g.max()!r} at {g_leaf}; "
             + worst_own(b["grads"], a["grads"], moved, "grad"),
             f"update leaf gaps: worst {u.max()!r} at {u_leaf}; against "
             f"its own norm worst {own[worst]!r} at {worst}, "
             f"{flips!r} of its elements change sign, its first gradient "
             f"{a['grads'][worst] / median!r} x the median leaf's",
             f"losses: {a['losses']} / {b['losses']}"]
    return numbers, notes


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def leaf_gaps(prog: dict, ref: dict, names) -> tuple[np.ndarray, str]:
    """(each leaf's gap of two {leaf: norm} readings over ``names``, against
    the reference's norm of that leaf or of the median leaf (of those the
    reference moves at all), whichever is larger; the worst leaf)."""
    median = float(np.median([ref[n] for n in names if ref[n] > 0]))
    gaps = np.array([abs(prog[n] - ref[n]) / max(ref[n], median)
                     for n in names])
    return gaps, names[int(np.argmax(gaps))]
