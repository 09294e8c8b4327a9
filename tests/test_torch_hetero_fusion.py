"""Port parity: H3GAT HeteroFusion (2 iterations, shared block, ego-only
last iteration) on both K/V relation folds — stacked-relation (dynamic
modes) and parameter-level (static fleet layout) — vs the flax module
on the CPU path (separable warp + XLA window attention).  Float32,
1e-5 absolute.

The block's routing knobs (``use_fused_wa``, ``use_stripe``,
``use_pallas``), the gather warp (``use_mxu_warp=False``),
``exclude_self`` and the parallel block with its SplitAttn are held to
the same flax module at 64^2, where the fused route's shape rule holds;
each case also checks, by counting wrapper calls, that the port took
the route the knob names.  1e-5, and 1e-4 where the gather warp's
coordinates enter (the frameworks round the affine chain ~1e-5 px
apart)."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.models import hetero_fusion as jhf
from hmvit_tpu_torch.models import hetero_fusion as phf
from hmvit_tpu_torch.nn import init_parameters
from tiny_cfg import TINY_CFG
from torch_parity import bridged, close, flax_variables, japply, \
    rigid_pairwise, t

ATOL = 1e-5
# through a 64 px warp: the frameworks round the affine chain ~1e-5 px
# apart, and a unit-normal map moves by up to ~2 per pixel of shift
WARP_ATOL = 1e-4


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


def _wide_case(seed=3, l=3, hw=64, c=32):
    x, mode, pair, agent = _case(seed, 1, l, hw, c)
    return x, mode, pair, np.ones_like(agent)


def _wide_cfg(**block):
    cfg = copy.deepcopy(TINY_CFG["hetero_fusion"])
    cfg["num_iters"] = 2
    cfg["hetero_fusion_block"].update(input_dim=32, mlp_dim=32, **block)
    return cfg


def _count_routes(monkeypatch):
    """Count the calls of each kernel wrapper the module can route to."""
    calls = {}
    for name in ("fused_warp_window_attention", "fused_pair_warp",
                 "fused_stripe_window_attention",
                 "fused_plain_window_attention",
                 "plain_window_attention_xla", "warp_bev_mxu",
                 "warp_bev_nhwc"):
        def counted(*a, _fn=getattr(phf, name), _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)
        monkeypatch.setattr(phf, name, counted)
    return calls


# per knob: the wrapper calls of 2 iterations (local, grid, local, grid)
ROUTES = {
    "default": ({}, {"fused_pair_warp": 4,
                     "fused_stripe_window_attention": 2,
                     "fused_plain_window_attention": 2}),
    "use_fused_wa": ({"use_fused_wa": True},
                     {"fused_warp_window_attention": 2, "fused_pair_warp": 2,
                      "fused_plain_window_attention": 2}),
    "no_stripe": ({"use_stripe": False},
                  {"fused_pair_warp": 4, "fused_plain_window_attention": 4}),
    "fused_wa_needs_stripe": ({"use_fused_wa": True, "use_stripe": False},
                              {"fused_pair_warp": 4,
                               "fused_plain_window_attention": 4}),
    "no_pallas": ({"use_pallas": False, "use_fused_wa": True},
                  {"warp_bev_mxu": 4, "plain_window_attention_xla": 4}),
}


@pytest.mark.parametrize("knob", sorted(ROUTES))
def test_hetero_fusion_routing_knobs(knob, monkeypatch):
    block, want_calls = ROUTES[knob]
    cfg = _wide_cfg(**block)
    x, mode, pair, agent = _wide_case()
    sm = tuple(int(m) for m in mode[0])
    jm = jhf.HeteroFusion(cfg)
    v = flax_variables(jm, x, mode, pair, agent, static_modes=sm)
    want = japply(jm, v, x, mode, pair, agent, static_modes=sm)
    pm = bridged(phf.HeteroFusion(cfg), v)
    calls = _count_routes(monkeypatch)
    with torch.no_grad():
        got = pm(t(x), t(mode), t(pair), t(agent), static_modes=sm)
    assert calls == want_calls
    close(got, want, WARP_ATOL)


def test_fused_wa_falls_back_on_small_maps(monkeypatch):
    """Below 56 px (or off the 32 grid) the knob leaves the default
    route, as the flax module's shape rule does."""
    cfg = _wide_cfg(use_fused_wa=True)
    x, mode, pair, agent = _wide_case(hw=16)
    pm = phf.HeteroFusion(cfg).eval()
    calls = _count_routes(monkeypatch)
    with torch.no_grad():
        pm(t(x), t(mode), t(pair), t(agent))
    assert "fused_warp_window_attention" not in calls
    assert calls["fused_stripe_window_attention"] == 2


COMMON = dict(dim=32, dim_head=16, window=4, discrete_ratio=0.64,
              downsample_rate=4.0)


def test_gather_warp_route_matches_flax():
    """use_pallas=False with use_mxu_warp=False: the gather warp."""
    x, mode, pair, agent = _wide_case(seed=4)
    kwargs = dict(COMMON, use_pallas=False, use_mxu_warp=False)
    jm = jhf.HeteroWindowAttention(**kwargs)
    v = flax_variables(jm, x, mode, pair, agent)
    want = japply(jm, v, x, mode, pair, agent)
    pm = bridged(phf.HeteroWindowAttention(**kwargs), v)
    with torch.no_grad():
        got = pm(t(x), t(mode), t(pair), t(agent))
    assert got.shape == want.shape == x.shape
    close(got, want, WARP_ATOL)


@pytest.mark.parametrize("kwargs", [
    dict(use_fused_wa=True), dict(), dict(use_stripe=False),
    dict(style="grid"), dict(use_pallas=False)])
def test_exclude_self_masks_the_diagonal(kwargs):
    """exclude_self on every route: the same message as a pair mask with
    the (i, i) pairs zeroed.  (Held to the port's own mask semantics:
    the flax module's split route, the only one it takes on the CPU,
    fails to broadcast its exclude_self mask.)"""
    x, mode, pair, agent = map(t, _wide_case(seed=4))
    pm = phf.HeteroWindowAttention(**COMMON, **kwargs)
    init_parameters(pm, seed=1)
    twin = phf.HeteroWindowAttention(**COMMON, exclude_self=True, **kwargs)
    twin.load_state_dict(pm.state_dict())
    mask = phf.pairwise_roi_mask(pair, agent, (64, 64), 0.64, 4.0)
    l = x.shape[1]
    no_diag = mask * (1.0 - torch.eye(l))[None, :, None, None, :]
    with torch.no_grad():
        want = pm(x, mode, pair, agent, pair_mask=no_diag)
        got = twin(x, mode, pair, agent, pair_mask=mask)
        base = pm(x, mode, pair, agent, pair_mask=mask)
    assert torch.equal(got, want)
    assert not torch.equal(got, base)


@pytest.mark.parametrize("ego_only_last", [True, False])
def test_parallel_block_with_split_attn(ego_only_last):
    """architect_mode="parallel": both phases on the same input, mixed
    by SplitAttn (bridged fc1, bn1, fc2); receivers restrict both."""
    cfg = copy.deepcopy(TINY_CFG["hetero_fusion"])
    cfg["num_iters"] = 2
    cfg["ego_only_last"] = ego_only_last
    cfg["hetero_fusion_block"]["architect_mode"] = "parallel"
    x, mode, pair, agent = _case(seed=5)
    jm = jhf.HeteroFusion(cfg)
    v = flax_variables(jm, x, mode, pair, agent)
    assert set(v["params"]["HeteroFusionBlock_0"]["SplitAttn_0"]) == {
        "fc1", "bn1", "fc2"}
    want = japply(jm, v, x, mode, pair, agent)
    pm = bridged(phf.HeteroFusion(cfg), v)
    with torch.no_grad():
        got = pm(t(x), t(mode), t(pair), t(agent))
    close(got, want, ATOL)


def test_split_attn_matches_flax():
    rng = np.random.default_rng(6)
    branches = [rng.standard_normal((2, 3, 4, 4, 16)).astype(np.float32)
                for _ in range(2)]
    jm = jhf.SplitAttn(16)
    v = flax_variables(jm, branches)
    pm = bridged(phf.SplitAttn(16), v)
    close(pm([t(b) for b in branches]), jm.apply(v, branches), ATOL)


def test_unknown_architect_mode_raises():
    cfg = copy.deepcopy(TINY_CFG["hetero_fusion"])
    cfg["hetero_fusion_block"]["architect_mode"] = "interleaved"
    with pytest.raises(ValueError):
        phf.HeteroFusion(cfg)
