"""Train mode of the ported modules against flax ``train=True`` /
``deterministic=False`` on the CPU, weights through ``bridge.py``:

* BatchNorm (batch statistics as flax computes them, flax's running
  update with each module's momentum: 0.9 in the ResNet, 0.99
  elsewhere), MaskedBatchNorm (masked rows only), the decoder, the lidar
  encoder and the fusion: the port in float32 against the flax module
  in float64 (``jax.enable_x64``: XLA's float32 train-mode lidar
  encoder on the CPU is itself 4.5e-5 from its float64 result, the
  port's 3.2e-6), outputs within 1e-5, updated ``batch_stats`` within
  1e-6;
* the ResNet-50 trunk in float64 (JAX under ``jax.enable_x64``, the
  port in double): train-mode BatchNorm makes its float32 gradients
  ill-conditioned (a 1e-7 relative input perturbation moves them by
  ~20% of their scale in either framework), so its arithmetic is held
  where rounding cannot hide a difference;
* the decoder's static branch is taken in eval mode only;
* Dropout: keep rate, 1 / (1 - p) scale, identity in eval mode and at
  rate 0, the same mask for the same (seed, step);
* remat with ``drop_out`` > 0: loss and gradients equal to the run
  without remat bit for bit, running statistics updated once, the
  recompute replaying the forward's masks.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from hmvit_tpu.models import hetero_fusion as jhf
from hmvit_tpu.models import layers as jl
from hmvit_tpu.models.pillar_encoder import PointPillarEncoder as JPPE
from hmvit_tpu.models.resnet import ResNetEncoder as JResNet
from hmvit_tpu_torch import nn as pnn
from hmvit_tpu_torch.bridge import flax_to_state_dict
from hmvit_tpu_torch.models import hetero_fusion as phf
from hmvit_tpu_torch.models import layers as pl
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.models.pillar_encoder import PointPillarEncoder
from hmvit_tpu_torch.models.resnet import ResNetEncoder
from hmvit_tpu_torch.ops.opcount import record_kernel_ops
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.train.losses import point_pillar_loss
from hmvit_tpu_torch.train.trainer import labels_for_batch, step_generator
from tiny_cfg import POSTPROCESS_CFG, TINY_CFG
from torch_parity import bridged, close, flax_variables, rigid_pairwise, t, \
    tiny_batch, tiny_flagship_cfg

OUT_ATOL = 1e-5
STATS_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _f64(tree):
    """float32 leaves of a tree of arrays -> float64 numpy."""
    def widen(a):
        a = np.asarray(a)
        return a.astype(np.float64) if a.dtype == np.float32 else a
    return jax.tree_util.tree_map(widen, tree)


def _japply_train(module, variables, *args, x64=True, **kwargs):
    """(output, new batch_stats) of a flax module in train mode, computed
    in float64 from the float32 variables and inputs (``x64``)."""
    if x64:
        variables, args = _f64(variables), _f64(args)
    with jax.enable_x64(x64):
        out, upd = jax.jit(lambda v, *a: module.apply(
            v, *a, mutable=["batch_stats"], **kwargs))(variables, *args)
        return _f64(out), _f64(upd)


def _stats_close(port_module, params, new_stats):
    """Every running statistic of ``port_module`` equals flax's updated
    ``batch_stats``."""
    want = flax_to_state_dict(port_module, {"params": params,
                                            "batch_stats": new_stats})
    names = [n for n, _ in port_module.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    assert names
    for name in names:
        close(port_module.get_buffer(name), want[name], STATS_ATOL)


@pytest.mark.parametrize("momentum,eps", [(0.9, 1e-5), (0.99, 1e-3)])
def test_batchnorm_train(momentum, eps):
    rng = np.random.default_rng(0)
    # an offset mean: the statistics' float32 promotion and the
    # E[x^2] - E[x]^2 form must both match flax's
    x = (3.0 + 2.0 * rng.standard_normal((4, 6, 5, 8))).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=eps)
    v = flax_variables(jm, x)
    want, upd = _japply_train(jm, v, x)
    pm = bridged(pnn.BatchNorm(8, eps, momentum), v).train()
    got = pm(t(x))
    close(got, want, OUT_ATOL)
    close(pm.running_mean, upd["batch_stats"]["mean"], STATS_ATOL)
    close(pm.running_var, upd["batch_stats"]["var"], STATS_ATOL)
    # eval mode reads the updated running statistics
    pm.eval()
    close(pm(t(x)), fnn.BatchNorm(use_running_average=True,
                                  momentum=momentum, epsilon=eps).apply(
        {"params": v["params"], "batch_stats": upd["batch_stats"]}, x),
        OUT_ATOL)


def test_batchnorm_bf16_input_keeps_float32_statistics():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 8)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    v = flax_variables(jm, x)
    want, upd = _japply_train(jm, v, xb, x64=False)
    pm = bridged(pnn.BatchNorm(8, 1e-3), v).train()
    got = pm(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
        torch.bfloat16))
    assert got.dtype == torch.float32 and pm.running_var.dtype == \
        torch.float32
    close(got, want, OUT_ATOL)
    close(pm.running_mean, upd["batch_stats"]["mean"], STATS_ATOL)
    close(pm.running_var, upd["batch_stats"]["var"], STATS_ATOL)


def test_masked_batchnorm_train():
    rng = np.random.default_rng(2)
    x = (1.5 + rng.standard_normal((2, 40, 8))).astype(np.float32)
    mask = (rng.random((2, 40)) < 0.6).astype(np.float32)
    jm = jl.MaskedBatchNorm()
    v = flax_variables(jm, x, mask)
    want, upd = _japply_train(jm, v, x, mask, train=True)
    pm = bridged(pl.MaskedBatchNorm(8), v).train()
    close(pm(t(x), t(mask) > 0), want, OUT_ATOL)
    close(pm.running_mean, upd["batch_stats"]["mean"], STATS_ATOL)
    close(pm.running_var, upd["batch_stats"]["var"], STATS_ATOL)


def test_naive_decoder_train():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
    jm = jl.NaiveDecoder(2, (16, 8), use_upsample=True)
    v = flax_variables(jm, x)
    want, upd = _japply_train(jm, v, x, train=True)
    pm = bridged(pl.NaiveDecoder(16, 2, (16, 8), use_upsample=True), v
                 ).train()
    close(pm(t(x)), want, OUT_ATOL)
    _stats_close(pm, v["params"], upd["batch_stats"])


def test_lidar_encoder_train():
    batch, _ = tiny_batch(0)
    pts, pmask = batch["points"][0, :3], batch["points_mask"][0, :3]
    jm = JPPE(TINY_CFG["lidar"])
    v = flax_variables(jm, pts, pmask)
    want, upd = _japply_train(jm, v, pts, pmask, train=True)
    pm = bridged(PointPillarEncoder(TINY_CFG["lidar"]), v).train()
    close(pm(t(pts), t(pmask)), want, OUT_ATOL)
    _stats_close(pm, v["params"], upd["batch_stats"])


def test_resnet_train_float64():
    """The trunk's train mode (momentum 0.9, eps 1e-5, XLA padding) in
    float64: outputs, updated statistics and the gradient of a loss on
    the outputs."""
    x = np.random.default_rng(4).standard_normal((3, 32, 32, 3))
    jm = JResNet(arch="resnet50", id_pick=(2, 3, 4))
    v = flax_variables(jm, x.astype(np.float32))
    v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

    def loss(params, stats, xx):
        outs, upd = jm.apply({"params": params, "batch_stats": stats}, xx,
                             train=True, mutable=["batch_stats"])
        return sum(jnp.mean(o) + jnp.mean(o[..., :7] ** 2) for o in outs), \
            (outs, upd["batch_stats"])

    with jax.enable_x64(True):
        (_, (want, stats)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(jax.tree_util.tree_map(
                jnp.asarray, v64["params"]), jax.tree_util.tree_map(
                jnp.asarray, v64["batch_stats"]), jnp.asarray(x))
        want = [np.asarray(w) for w in want]
        ref = flax_to_state_dict(
            ResNetEncoder("resnet50", (2, 3, 4)),
            jax.tree_util.tree_map(np.asarray,
                                   {"params": grads, "batch_stats": stats}))
    pm = ResNetEncoder("resnet50", (2, 3, 4)).double()
    pm.load_state_dict(flax_to_state_dict(pm, v64))
    pm.train()
    outs = pm(torch.from_numpy(x))
    sum(o.mean() + (o[..., :7] ** 2).mean() for o in outs).backward()
    for got, w in zip(outs, want):
        scale = max(1.0, float(np.abs(w).max()))
        close(got / scale, w / scale, OUT_ATOL)
    for name, buf in pm.named_buffers():
        close(buf, ref[name], STATS_ATOL)
    for name, p in pm.named_parameters():
        scale = max(1e-30, float(ref[name].abs().max()))
        close(p.grad / scale, ref[name] / scale, 1e-4)


def _fusion_inputs(seed=5, b=1, l=3, hw=16, c=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, hw, hw, c)).astype(np.float32)
    mode = np.array([[1, 0, 1]], np.int32)
    agent_mask = np.ones((b, l), np.float32)
    pairwise = rigid_pairwise(rng, b, l, max_t=4.0)
    return x, mode, pairwise, agent_mask


def test_hetero_fusion_train_without_dropout():
    cfg = copy.deepcopy(TINY_CFG["hetero_fusion"])
    cfg["num_iters"] = 2
    args = _fusion_inputs()
    jm = jhf.HeteroFusion(cfg)
    v = flax_variables(jm, *args)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda vv, *a: jm.apply(
            vv, *a, deterministic=False))(_f64(v), *_f64(args)))
    pm = bridged(phf.HeteroFusion(cfg), v).train()
    close(pm(*map(t, args)), want, OUT_ATOL)


def test_decoder_static_branch_in_eval_only():
    cfg = tiny_flagship_cfg()
    batch, _ = tiny_batch(2)
    tb = {k: t(v) for k, v in batch.items()}
    model = pnn.init_parameters(HMViT(cfg), seed=0)
    dec = model.HeteroDecoder_0
    x = torch.randn(1, 16, 16, 64, generator=torch.Generator().manual_seed(0))
    ego = tb["mode"][:, 0].long()
    dec.train()
    before = {n: b.clone() for n, b in dec.named_buffers()}
    got = dec(x, ego, static_ego_modality=int(ego[0]))
    # both branches ran and normalised over the batch
    assert all(not torch.equal(before[n], b) for n, b in
               dec.named_buffers() if n.endswith("running_mean"))
    want = dec(x, ego)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    dec.eval()
    with torch.no_grad():
        psm, _ = dec(x, ego, static_ego_modality=int(ego[0]))
        name = "lidar" if int(ego[0]) == 1 else "camera"
        branch = getattr(dec, f"{name}_head")(
            getattr(dec, f"{name}_decoder")(x))
    assert torch.equal(psm, branch[0])


def test_train_and_eval_switch_every_module():
    model = HMViT(tiny_flagship_cfg())
    assert not any(m.training for m in model.modules())
    assert model.train() is model
    assert all(m.training for m in model.modules())
    assert model.eval() is model
    assert not any(m.training for m in model.modules())


# -- dropout --------------------------------------------------------------

def test_dropout_semantics():
    x = torch.ones(200_000)
    drop = pnn.Dropout(0.3)
    assert drop.eval()(x) is x
    with pytest.raises(RuntimeError, match="dropout_rng"):
        drop.train()(x)
    with pnn.dropout_rng(step_generator(0, 5, "cpu")):
        y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    with pnn.dropout_rng(step_generator(0, 5, "cpu")):
        assert torch.equal(drop(x), y)
    with pnn.dropout_rng(step_generator(0, 6, "cpu")):
        assert not torch.equal(drop(x), y)
    with pnn.dropout_rng(step_generator(1, 5, "cpu")):
        assert not torch.equal(drop(x), y)
    # rate 0 draws nothing, rate 1 zeroes
    assert pnn.Dropout(0.0).train()(x) is x
    with pnn.dropout_rng(step_generator(0, 0, "cpu")):
        assert torch.equal(pnn.Dropout(1.0).train()(x), torch.zeros_like(x))


def test_dropout_is_wired_where_jax_reads_drop_out():
    cfg = tiny_flagship_cfg()
    cfg["hetero_fusion"]["hetero_fusion_block"]["drop_out"] = 0.25
    model = HMViT(cfg)
    rates = {name: m.rate for name, m in model.named_modules()
             if isinstance(m, pnn.Dropout)}
    blk = "fusion.HeteroFusionBlock_0."
    for phase in ("window", "grid"):
        assert rates[blk + f"{phase}_attn.Dropout_0"] == 0.25
        assert rates[blk + f"{phase}_ffn.Dropout_0"] == 0.25
        assert rates[blk + f"{phase}_ffn.Dropout_1"] == 0.25
    # the fusion's MLP head keeps flax's default rate, 0
    assert rates["fusion.mlp_head.Dropout_0"] == 0.0
    assert rates["fusion.mlp_head.Dropout_1"] == 0.0


# -- remat ----------------------------------------------------------------

def _remat_run(monkeypatch, remat, drop_out):
    cfg = tiny_flagship_cfg()
    cfg["hetero_fusion"]["hetero_fusion_block"]["drop_out"] = drop_out
    cfg["remat"] = remat
    model = pnn.init_parameters(HMViT(cfg), seed=0).train()
    batch, _ = tiny_batch(2)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    labels = labels_for_batch(pp, pp.generate_anchor_box(), batch)
    draws = []
    rand = torch.rand

    def counted_rand(*a, **k):
        draws.append(None)
        return rand(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(torch, "rand", counted_rand)
        with pnn.dropout_rng(step_generator(3, 0, "cpu")), \
                record_kernel_ops() as calls:
            out = model({k: t(v) for k, v in batch.items()})
            total, _ = point_pillar_loss(out, labels)
            forward_draws = len(draws)
            total.backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    return (float(total), grads, stats, forward_draws, len(draws),
            [name for name, _ in calls])


@pytest.mark.parametrize("stages", [True, ["fusion"]])
def test_remat_replays_masks_and_updates_stats_once(monkeypatch, stages):
    loss0, g0, s0, d0, d0_all, calls0 = _remat_run(monkeypatch, False, 0.3)
    loss1, g1, s1, d1, d1_all, calls1 = _remat_run(monkeypatch, stages, 0.3)
    assert loss0 == loss1
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    # running statistics: one update, the same as without remat
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n
    # the recompute drew the masks again (the same ones: the gradients
    # are equal) and launched the fusion's kernel wrappers again
    assert d0 == d0_all == d1 > 0 and d1_all == 2 * d1
    fusion = ("pair_warp", "stripe_window_attention")
    for name in fusion:
        assert calls1.count(name) == 2 * calls0.count(name) > 0
