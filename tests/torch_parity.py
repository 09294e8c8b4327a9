"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*):
seeded numpy inputs and flax variables, the tiny mixed-fleet config, and
the JAX -> port weight bridge."""
from __future__ import annotations

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

# imported before any trace: the module builds jnp constants at import
import hmvit_tpu.models.bevformer  # noqa: F401
from hmvit_tpu_torch.bridge import load_flax

from tiny_cfg import RANGE, TINY_CFG

# tiny flagship: lidar PointPillars + bevformer planar camera branch on
# a ResNet-50/FPN trunk, 2 H3GAT iterations (the serving structure of
# bench.py PROD_CFG at test widths)
TINY_CAMERA = {"encoder": "bevformer", "lift": "planar",
               "backbone": "resnet50", "id_pick": [2, 3, 4], "fpn": True,
               "fpn_channels": 16, "dim": 32, "bev_size": 16, "out_dim": 64,
               "num_layers": 1, "heads": 2, "window": 4,
               "num_points_in_pillar": 2, "decoder_layers": 0,
               "bev_range": 20.48, "num_cams": 2}


def tiny_flagship_cfg():
    cfg = copy.deepcopy(TINY_CFG)
    cfg["camera"] = copy.deepcopy(TINY_CAMERA)
    cfg["hetero_fusion"]["num_iters"] = 2
    return cfg


def tiny_batch(seed=0, num_agents=4, max_cav=5):
    from hmvit_tpu.data.synthetic import make_hetero_batch

    batch, gt = make_hetero_batch(
        seed=seed, max_cav=max_cav, num_agents=num_agents, max_points=512,
        image_size=64, num_cams=2, camera_ratio=0.5, ego_mode="mixed",
        lidar_range=RANGE)
    for i in range(num_agents):  # alternating lidar/camera fleet
        batch["mode"][:, i] = (i + 1) % 2
    return batch, gt


def random_variables(shapes, seed=0):
    """A flax variables tree with the shapes of ``shapes`` (from
    jax.eval_shape of init), drawn from numpy at fan-in scales, with
    non-trivial BatchNorm statistics so eps and layout mistakes show."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        coll = str(getattr(path[0], "key", path[0]))
        shp = s.shape
        if coll == "batch_stats":
            if name == "var":
                return rng.uniform(0.5, 1.5, shp).astype(np.float32)
            return (0.1 * rng.standard_normal(shp)).astype(np.float32)
        if name == "kernel":
            fan_in = shp[1] if len(shp) == 3 else int(np.prod(shp[:-1]))
            return (rng.standard_normal(shp) / np.sqrt(fan_in)).astype(
                np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shp)).astype(np.float32)
        if name in ("relation_att", "relation_msg"):
            return (rng.standard_normal(shp) / np.sqrt(shp[-1])).astype(
                np.float32)
        if name in ("rel_pos_bias", "bev_embedding"):
            return (0.5 * rng.standard_normal(shp)).astype(np.float32)
        return (0.1 * rng.standard_normal(shp)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flax_variables(module, *args, seed=0, **kwargs):
    """Random variables for a flax module, without running its init."""
    shapes = jax.eval_shape(
        lambda *a: module.init(jax.random.key(0), *a, **kwargs), *args)
    return random_variables(shapes, seed)


def flax_tree(port_module, shapes):
    """The inverse of the bridge: a flax variables tree, of the structure
    of ``shapes`` (``jax.eval_shape`` of the flax module's init), holding
    ``port_module``'s tensors as numpy (e.g. the port's own seeded
    initialisation, which draws flax's default distributions)."""
    def unconvert(arr, kind):
        if kind == "dense":
            return arr.T
        if kind == "conv":
            return arr.transpose(2, 3, 1, 0)
        if kind == "conv3d":
            return arr.transpose(2, 3, 4, 1, 0)
        if kind == "conv_transpose":
            return arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
        return arr

    leaves = {}
    for key, tensor in port_module.state_dict().items():
        mod_path, _, leaf = key.rpartition(".")
        module = port_module.get_submodule(mod_path) if mod_path \
            else port_module
        coll, flax_leaf, kind = getattr(module, "flax_leaves", {}).get(
            leaf, ("params", leaf, "copy"))
        path = (coll, *(mod_path.split(".") if mod_path else ()), flax_leaf)
        leaves[path] = np.ascontiguousarray(unconvert(tensor.numpy(), kind))

    def fill(path, s):
        key = tuple(str(getattr(p, "key", p)) for p in path)
        arr = leaves.pop(key)
        assert arr.shape == s.shape, (key, arr.shape, s.shape)
        return arr

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    assert not leaves, sorted(leaves)[:4]
    return tree


def bridged(port_module, variables):
    """Load flax variables into a port module (eval mode, CPU)."""
    load_flax(port_module, jax.tree_util.tree_map(np.asarray, variables))
    return port_module.eval()


@contextlib.contextmanager
def widened_bf16_einsum():
    """While tracing a bfloat16 JAX model on the CPU: ``jnp.einsum`` on
    bf16 operands with ``preferred_element_type=float32`` takes the
    operands widened to float32.  XLA on the CPU has no bf16 x bf16 ->
    fp32 product with more than one batch dimension (the camera encoder's
    and the fusion's einsums).  The result is the same: a product of two
    bf16 values is exact in float32, and the sum is float32 either way
    (only its order is the library's)."""
    einsum = jnp.einsum

    def widened(subscripts, *operands, preferred_element_type=None,
                **kwargs):
        if preferred_element_type == jnp.float32:
            operands = [o.astype(jnp.float32)
                        if jnp.asarray(o).dtype == jnp.bfloat16 else o
                        for o in operands]
        return einsum(subscripts, *operands,
                      preferred_element_type=preferred_element_type,
                      **kwargs)

    jnp.einsum = widened
    try:
        yield
    finally:
        jnp.einsum = einsum


def t(x):
    """numpy / jax array -> torch tensor on the CPU."""
    return torch.from_numpy(np.array(x))


def close(got, want, atol, rtol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def rigid_pairwise(rng, b, l, max_t=8.0, angles=None):
    """(B, L, L, 4, 4) pairwise transforms of random rigid agent poses;
    pairwise[b, j, i] maps j's frame into i's."""
    ang = (rng.uniform(-np.pi, np.pi, (b, l)) if angles is None
           else np.broadcast_to(np.asarray(angles, np.float64), (b, l)))
    pos = rng.uniform(-max_t, max_t, (b, l, 2))
    m = np.tile(np.eye(4), (b, l, 1, 1))
    m[:, :, 0, 0] = np.cos(ang)
    m[:, :, 0, 1] = -np.sin(ang)
    m[:, :, 1, 0] = np.sin(ang)
    m[:, :, 1, 1] = np.cos(ang)
    m[:, :, :2, 3] = pos
    return np.einsum("bixy,bjyz->bjixz", np.linalg.inv(m), m).astype(
        np.float32)


def japply(module, variables, *arrays, **static):
    """module.apply under jax.jit (one compile instead of per-op
    dispatch); keyword arguments are static."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **static))(
        variables, *arrays)


# Tensor methods that read a tensor back to the host: each waits for the
# device, and none of them can run inside a CUDA-graph capture
HOST_READS = frozenset({
    torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.numpy,
    torch.Tensor.cpu, torch.Tensor.__int__, torch.Tensor.__bool__,
    torch.Tensor.__float__, torch.Tensor.__index__})


def _host_index(index) -> bool:
    """Whether an index holds host data that indexing copies to the
    device (a list, or a numpy array), rather than ints, slices and
    tensors."""
    parts = index if isinstance(index, tuple) else (index,)
    return any(isinstance(p, (list, np.ndarray)) for p in parts)


class NoHostReads(torch.overrides.TorchFunctionMode):
    """Raises AssertionError on a host read of a tensor (:data:`HOST_READS`)
    and on indexing with host data (a list or numpy array index, which is
    copied to the device at every call)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in HOST_READS:
            raise AssertionError(f"host read: Tensor.{func.__name__}")
        if func in (torch.Tensor.__getitem__, torch.Tensor.__setitem__) \
                and _host_index(args[1]):
            raise AssertionError(f"indexing with host data: {args[1]!r}")
        return func(*args, **kwargs)


@contextlib.contextmanager
def no_host_copies(monkeypatch):
    """Raises AssertionError on ``torch.tensor`` / ``torch.as_tensor`` with
    a ``device`` (a blocking host-to-device copy; PyTorch's function
    modes do not see these two, so they are patched)."""
    def guarded(fn):
        def call(*args, **kwargs):
            if kwargs.get("device") is not None:
                raise AssertionError(f"host-to-device copy: torch."
                                     f"{fn.__name__}(..., device="
                                     f"{kwargs['device']!r})")
            return fn(*args, **kwargs)
        return call

    with monkeypatch.context() as m:
        m.setattr(torch, "tensor", guarded(torch.tensor))
        m.setattr(torch, "as_tensor", guarded(torch.as_tensor))
        yield


# -- train steps ------------------------------------------------------------

def f64(tree):
    """float32 leaves of a tree of arrays -> float64 numpy."""
    def widen(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a
    return jax.tree_util.tree_map(widen, tree)


def adamw_update(tx, grads, opt_state, params):
    """One optax update: (new params, new optimizer state)."""
    import optax

    updates, opt_state = tx.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state


def jax_adamw_steps(jm, variables, batch, labels, x64, lr, weight_decay,
                    steps=2, loss=None, **apply_kwargs):
    """``steps`` train steps of the flax model ``jm`` (``loss``, by
    default the point-pillar loss; ``optax.adamw``), computed in float64
    under ``jax.enable_x64`` (``x64``) or in float32.  Returns [(loss,
    grads, batch_stats after the step)] and the params after the last
    step, as float64 numpy."""
    import optax

    from hmvit_tpu.train.losses import point_pillar_loss

    jloss = loss or point_pillar_loss

    conv = f64 if x64 else (lambda tr: jax.tree_util.tree_map(np.asarray,
                                                              tr))
    with jax.enable_x64(x64):
        jb = {k: jnp.asarray(v) for k, v in conv(batch).items()}
        jl = {k: jnp.asarray(v) for k, v in conv(labels).items()}
        params = jax.tree_util.tree_map(jnp.asarray,
                                        conv(variables["params"]))
        stats = jax.tree_util.tree_map(jnp.asarray,
                                       conv(variables["batch_stats"]))

        def compute(p, bs):
            out, upd = jm.apply({"params": p, "batch_stats": bs}, jb,
                                train=True, mutable=["batch_stats"],
                                **apply_kwargs)
            return jloss(out, jl)[0], upd["batch_stats"]

        grad_fn = jax.jit(jax.value_and_grad(compute, has_aux=True))
        tx = optax.adamw(lr, weight_decay=weight_decay)
        opt_state = tx.init(params)
        update = jax.jit(lambda g, o, p: adamw_update(tx, g, o, p))
        out = []
        for _ in range(steps):
            (loss, stats), grads = grad_fn(params, stats)
            params, opt_state = update(grads, opt_state, params)
            out.append((float(loss), f64(grads), f64(stats)))
        return out, f64(params)


def held_to_yardstick(got, ref64, ref32, rel, floor=0.0):
    """Per tensor of ``got`` (port, float32): |got - ref64| (JAX, float64)
    within max(rel x its largest |ref64|, floor) or, where JAX's own
    float32 result ``ref32`` lies farther than half that from ref64,
    within twice JAX's distance.  Returns the worst (error / bar, name)."""
    worst = (0.0, None)
    for name, g in got.items():
        want = ref64[name]
        err = float((g.double() - want).abs().max())
        jax_err = float((ref32[name] - want).abs().max())
        bar = max(rel * float(want.abs().max()), floor, 2.0 * jax_err)
        worst = max(worst, (err / bar if bar > 0 else np.inf * err, name))
    return worst
