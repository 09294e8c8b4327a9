"""Port parity: H3GAT HeteroFusion (2 iterations, shared block, ego-only
last iteration) on both K/V relation folds — stacked-relation (dynamic
modes) and parameter-level (static fleet layout) — vs the flax module
on the CPU path (separable warp + XLA window attention).  Float32,
1e-5 absolute."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import hetero_fusion as jhf
from hmvit_tpu_torch.models import hetero_fusion as phf
from tiny_cfg import TINY_CFG
from torch_parity import bridged, close, flax_variables, japply, \
    rigid_pairwise, t

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _case(seed=0, b=1, l=5, hw=16, c=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, hw, hw, c)).astype(np.float32)
    pair = rigid_pairwise(rng, b, l, max_t=10.0)
    mode = np.array([[1, 0, 1, 0, 1]], np.int32)[:, :l].repeat(b, 0)
    agent = np.ones((b, l), np.float32)
    agent[:, -1] = 0.0  # a padded slot
    return x, mode, pair, agent


@pytest.mark.parametrize("static", [False, True])
def test_hetero_fusion_both_kv_folds(static):
    cfg = copy.deepcopy(TINY_CFG["hetero_fusion"])
    cfg["num_iters"] = 2
    x, mode, pair, agent = _case()
    sm = tuple(int(m) for m in mode[0]) if static else None
    jm = jhf.HeteroFusion(cfg)
    v = flax_variables(jm, x, mode, pair, agent, static_modes=sm)
    want = japply(jm, v, x, mode, pair, agent, static_modes=sm)
    pm = bridged(phf.HeteroFusion(cfg), v)
    with torch.no_grad():
        got = pm(t(x), t(mode), t(pair), t(agent), static_modes=sm)
    assert got.shape == want.shape == (1, 16, 16, 64)
    close(got, want, ATOL)


@pytest.mark.parametrize("style", ["local", "grid"])
def test_window_split_merge(style):
    x = np.random.default_rng(1).standard_normal((2, 3, 8, 12, 5)).astype(
        np.float32)
    want = jhf._window_split(jnp.asarray(x), 4, style)
    got = phf._window_split(t(x), 4, style)
    close(got, want, 0)
    close(phf._window_merge(got, 4, style, 8, 12), x, 0)


def test_relative_position_index():
    assert np.array_equal(phf.relative_position_index(4),
                          jhf.relative_position_index(4))
