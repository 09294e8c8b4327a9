"""Port parity: hmvit_tpu_torch layers vs the flax modules they mirror,
with weights moved by the bridge.  Float32 on the CPU; tolerance 1e-5
absolute (same arithmetic, other summation order) unless stated.

Also pins the numerics traps of the port: flax LayerNorm eps 1e-6 vs
HeteroLayerNorm 1e-5 single-pass, tanh GELU, per-module BatchNorm eps,
XLA 'SAME' padding, and the spatially flipped ConvTranspose kernel."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from hmvit_tpu.models import layers as jl
from hmvit_tpu.models.pillar_encoder import BEVBackbone as JBEVBackbone
from hmvit_tpu_torch import nn as pnn
from hmvit_tpu_torch.models import layers as pl
from hmvit_tpu_torch.models.pillar_encoder import BEVBackbone
from torch_parity import bridged, close, flax_variables, t

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


MODE = np.array([[1, 0, 1], [0, 0, 1]], np.int32)


@pytest.mark.parametrize("static", [False, True])
def test_hetero_dense(static):
    x = _x((2, 3, 4, 4, 8))
    sm = (1, 0, 1) if static else None
    mode = MODE[:1].repeat(2, 0) if static else MODE
    jm = jl.HeteroDense(6)
    v = flax_variables(jm, x, mode, static_modes=sm)
    want = jm.apply(v, x, mode, static_modes=sm)
    pm = bridged(pl.HeteroDense(8, 6), v)
    close(pm(t(x), t(mode), sm), want, ATOL)
    kernel, bias = pm(t(x), t(mode), return_params=True)
    close(kernel, v["params"]["kernel"], 0)
    close(bias, v["params"]["bias"], 0)


def test_hetero_layernorm_single_pass_eps():
    x = _x((2, 3, 4, 4, 8)) * 3.0 + 1.0
    jm = jl.HeteroLayerNorm()
    v = flax_variables(jm, x, MODE)
    close(bridged(pl.HeteroLayerNorm(8), v)(t(x), t(MODE)),
          jm.apply(v, x, MODE), ATOL)


def test_hetero_feedforward_tanh_gelu():
    x = _x((2, 3, 4, 4, 8)) * 2.0
    jm = jl.HeteroFeedForward(16)
    v = flax_variables(jm, x, MODE)
    pm = bridged(pl.HeteroFeedForward(8, 16), v)
    want = jm.apply(v, x, MODE)
    close(pm(t(x), t(MODE)), want, ATOL)
    # the exact (erf) GELU would differ by far more than the tolerance
    h = pm.HeteroDense_0(t(x), t(MODE))
    exact = pm.HeteroDense_1(torch.nn.functional.gelu(h), t(MODE))
    assert np.abs(exact.detach().numpy() - np.asarray(want)).max() > 10 * ATOL


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_bn_relu_symmetric_pad_eps(stride):
    x = _x((2, 10, 10, 4))
    jm = jl.ConvBNReLU(6, stride=stride)
    v = flax_variables(jm, x)
    close(bridged(pl.ConvBNReLU(4, 6, stride=stride), v)(t(x)),
          jm.apply(v, x), ATOL)


@pytest.mark.parametrize("upsample", [False, True])
def test_naive_decoder(upsample):
    x = _x((1, 6, 6, 8))
    jm = jl.NaiveDecoder(2, (8, 4), use_upsample=upsample)
    v = flax_variables(jm, x)
    close(bridged(pl.NaiveDecoder(8, 2, (8, 4), use_upsample=upsample),
                  v)(t(x)), jm.apply(v, x), ATOL)


def test_detection_head():
    x = _x((1, 6, 6, 8))
    jm = jl.DetectionHead(2)
    v = flax_variables(jm, x)
    psm, rm = bridged(pl.DetectionHead(8, 2), v)(t(x))
    jpsm, jrm = jm.apply(v, x)
    close(psm, jpsm, ATOL)
    close(rm, jrm, ATOL)


def test_masked_batchnorm_eval():
    x = _x((50, 8))
    mask = np.ones(50, bool)
    jm = jl.MaskedBatchNorm()
    v = flax_variables(jm, x, mask)
    close(bridged(pl.MaskedBatchNorm(8), v)(t(x)), jm.apply(v, x, mask),
          ATOL)


def test_flax_layernorm_eps_1e6():
    """flax nn.LayerNorm defaults to eps 1e-6; torch's default 1e-5 would
    show on small-variance rows."""
    x = _x((3, 8)) * 1e-3
    jm = fnn.LayerNorm()
    v = flax_variables(jm, x)
    pm = bridged(pnn.LayerNorm(8), v)
    close(pm(t(x)), jm.apply(v, x), 1e-4)
    torch_default = torch.nn.functional.layer_norm(
        t(x), (8,), pm.weight, pm.bias)
    assert np.abs(torch_default.detach().numpy()
                  - np.asarray(jm.apply(v, x))).max() > 1e-2


@pytest.mark.parametrize("size,k,s", [(512, 7, 2), (64, 3, 2), (64, 1, 2),
                                      (9, 3, 1)])
def test_conv_xla_same_padding(size, k, s):
    x = _x((1, size, size, 3))
    jm = fnn.Conv(4, (k, k), strides=(s, s), padding="SAME", use_bias=False)
    v = flax_variables(jm, x)
    close(bridged(pnn.Conv(3, 4, k, s, use_bias=False), v)(t(x)),
          jm.apply(v, x), 1e-4)


def test_max_pool_same():
    x = _x((1, 16, 16, 3))
    close(pnn.max_pool_same(t(x), 3, 2),
          fnn.max_pool(jnp.asarray(x), (3, 3), (2, 2), padding="SAME"), 0)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_conv_transpose_needs_spatial_flip(k):
    x = _x((1, 5, 5, 6))
    jm = fnn.ConvTranspose(3, (k, k), strides=(k, k), use_bias=False)
    v = flax_variables(jm, x)
    want = np.asarray(jm.apply(v, x))
    pm = bridged(pnn.ConvTranspose(6, 3, k, k), v)
    close(pm(t(x)), want, ATOL)
    if k > 1:  # the unflipped kernel is a different map
        kern = np.asarray(v["params"]["kernel"]).transpose(2, 3, 0, 1)
        wrong = torch.nn.functional.conv_transpose2d(
            t(x).permute(0, 3, 1, 2), t(kern), stride=k).permute(0, 2, 3, 1)
        assert np.abs(wrong.numpy() - want).max() > 0.1


def test_bev_backbone_deblocks():
    x = _x((1, 16, 16, 4))
    args = dict(layer_nums=[1, 1], layer_strides=[2, 2],
                num_filters=[6, 8], upsample_strides=[1, 2])
    jm = JBEVBackbone(num_upsample_filters=[5, 5], **args)
    v = flax_variables(jm, x)
    pm = bridged(BEVBackbone(4, args["layer_nums"], args["layer_strides"],
                             args["num_filters"], args["upsample_strides"],
                             [5, 5]), v)
    close(pm(t(x)), jm.apply(v, x), ATOL)


def test_port_init_draws_flax_distributions():
    """Seeded port init: deterministic, lecun-scaled kernels, identity
    BatchNorm, the detection head's focal prior bias."""
    a = pnn.init_parameters(pl.DetectionHead(64, 2), seed=3)
    b = pnn.init_parameters(pl.DetectionHead(64, 2), seed=3)
    assert torch.equal(a.Conv_1.weight, b.Conv_1.weight)
    std = float(a.Conv_1.weight.detach().std())
    assert abs(std - 1 / 8) < 0.02  # variance 1 / fan_in
    close(a.Conv_0.bias, np.full(2, -np.log(99.0)), 1e-6)
    bn = pnn.init_parameters(pnn.BatchNorm(4, 1e-3), seed=0)
    assert float(bn.running_var.min()) == 1.0


def test_jax_and_port_gelu_agree():
    x = np.linspace(-6, 6, 101).astype(np.float32)
    close(pnn.gelu(t(x)), jax.nn.gelu(jnp.asarray(x)), 1e-6)
