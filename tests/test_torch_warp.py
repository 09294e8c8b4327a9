"""Port parity: BEV warp geometry and the pair-warp kernel's plain twin.

Geometry (float32): transforms, affines and source coordinates within
1e-4 absolute of the JAX package; ROI masks (rounded coordinates) must
be identical.  The pair-warp twin is held against the JAX oracle
pair_warp_xla within 1e-4 and against the Pallas kernel in interpret
mode within 2e-4 (the Pallas tests' own tolerance) at H = W = 64, the
Pallas minimum, on unit-normal maps."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.ops import fused_warp as jfw
from hmvit_tpu.ops import shear_warp as jsw
from hmvit_tpu.ops import warp as jw
from hmvit_tpu_torch.ops import fused_warp as pfw
from hmvit_tpu_torch.ops import shear_warp as psw
from hmvit_tpu_torch.ops import warp as pw
from torch_parity import close, rigid_pairwise, t

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _transforms(seed, n=6, max_t=20.0):
    rng = np.random.default_rng(seed)
    return rigid_pairwise(rng, 1, n, max_t=max_t).reshape(-1, 4, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_affine_chain(seed):
    tf = _transforms(seed)
    m = jw.discretize_transform(tf, 0.4, 4)
    close(pw.discretize_transform(t(tf), 0.4, 4), m, ATOL)
    c = jw.centered_affine(m, (32, 32))
    close(pw.centered_affine(t(np.asarray(m)), (32, 32)), c, 1e-4)
    close(psw._pixel_affine(t(np.asarray(c)), (32, 32), (32, 32)),
          jsw._pixel_affine(c, (32, 32), (32, 32)), 1e-4)
    px, py = jw._source_coords(c, (32, 32), (32, 32))
    qx, qy = pw._source_coords(t(np.asarray(c)), (32, 32), (32, 32))
    close(qx, px, 1e-4)
    close(qy, py, 1e-4)


@pytest.mark.parametrize("seed", [0, 3])
def test_roi_masks_identical(seed):
    rng = np.random.default_rng(seed)
    pair = rigid_pairwise(rng, 2, 3, max_t=15.0)
    agent = np.array([[1, 1, 0], [1, 1, 1]], np.float32)
    want = jw.roi_and_agent_mask(6, 3, 16, 16,
                                 jnp.repeat(jnp.asarray(agent), 3, 0),
                                 jnp.asarray(pair.reshape(6, 3, 4, 4)),
                                 0.4, 4)
    got = pw.roi_and_agent_mask(6, 3, 16, 16, t(agent).repeat_interleave(3, 0),
                                t(pair.reshape(6, 3, 4, 4)), 0.4, 4)
    assert np.array_equal(got.numpy(), np.asarray(want))
    from hmvit_tpu.models.hetero_fusion import pairwise_roi_mask as jprm
    from hmvit_tpu_torch.models.hetero_fusion import pairwise_roi_mask
    assert np.array_equal(
        pairwise_roi_mask(t(pair), t(agent), (16, 16), 0.4, 4).numpy(),
        np.asarray(jprm(jnp.asarray(pair), jnp.asarray(agent), (16, 16),
                        0.4, 4)))


def test_warp_bev_mxu_matches():
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((6, 16, 16, 8)).astype(np.float32)
    tf = _transforms(2, max_t=6.0)[:6]
    close(psw.warp_bev_mxu(t(feats), t(tf), 0.4, 4),
          jsw.warp_bev_mxu(feats, tf, 0.4, 4), ATOL)


B, L, H, CK = 1, 3, 64, 16
# the two frameworks round the 3x3 affine chain differently (~1e-5 px at
# 64 px); a unit-normal map moves by at most ~2 per pixel of shift
WARP_ATOL = 1e-4


def _pair_case(seed, angles=None, max_t=8.0, l=L):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((B, 2, l, H, H, CK)).astype(np.float32)
    pair = rigid_pairwise(rng, B, l, max_t=max_t, angles=angles)
    mode = rng.integers(0, 2, (B, l)).astype(np.int32)
    return src, pair, mode


CASES = {
    "random": dict(seed=0),
    "near_90deg": dict(seed=1, angles=[np.pi / 2 - 1e-3, -np.pi / 2 + 2e-3,
                                       np.pi / 2 + 5e-4]),
    "identity_pairs": dict(seed=2, angles=[0.0, 0.0, 0.0], max_t=0.0),
    "far_translation": dict(seed=3, max_t=40.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("receivers", [None, 1])
def test_pair_warp_twin_vs_pallas_and_oracle(case, receivers):
    src, pair, mode = _pair_case(**CASES[case])
    got = pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0,
                              receivers).numpy()
    oracle = np.asarray(jfw.pair_warp_xla(jnp.asarray(src), jnp.asarray(pair),
                                          jnp.asarray(mode), 1.0, 1.0,
                                          receivers))
    pallas = np.asarray(jfw.pallas_pair_warp(
        jnp.asarray(src), jnp.asarray(pair), jnp.asarray(mode), 1.0, 1.0,
        interpret=True, num_receivers=receivers))
    assert got.shape == oracle.shape == pallas.shape
    close(got, oracle, WARP_ATOL)
    close(got, pallas, 2e-4)
    if case == "identity_pairs":
        for i in range(got.shape[1]):  # receiver i, sender i: its own map
            close(got[0, i, i], src[0, mode[0, i], i], ATOL)


@pytest.mark.parametrize("case", ["random", "near_90deg"])
@pytest.mark.parametrize("receivers", [None, 1])
def test_resident_variant_twin_vs_pallas_resident(case, receivers):
    """variant="resident": the Pallas resident kernel (interpret mode)
    against the port's wrapper on the CPU, which runs the one twin both
    variants share.  1e-4, the bar of the pair-warp case above."""
    src, pair, mode = _pair_case(**CASES[case])
    got = pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0, receivers,
                              variant="resident").numpy()
    pallas = np.asarray(jfw.pallas_pair_warp(
        jnp.asarray(src), jnp.asarray(pair), jnp.asarray(mode), 1.0, 1.0,
        interpret=True, num_receivers=receivers, variant="resident"))
    assert got.shape == pallas.shape
    close(got, pallas, WARP_ATOL)
    tile = pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0, receivers,
                               variant="tile").numpy()
    assert np.array_equal(got, tile)


@pytest.mark.parametrize("variant,h,w,want", [
    ("auto", 128, 128, "tile"), ("tile", 128, 128, "tile"),
    ("resident", 128, 128, "resident"), ("resident", 64, 64, "resident"),
    ("resident", 160, 160, "resident"),
    ("resident", 192, 192, "tile"),    # does not fit a block's shared memory
    ("resident", 48, 48, "tile"),      # below 64
    ("resident", 72, 72, "tile"),      # not a multiple of 32
    ("resident", 64, 128, "tile"),     # not square
])
def test_pair_warp_variant_routing(variant, h, w, want):
    """The JAX rule: auto = tile; resident only on a square map with
    h >= 64 and h % 32 == 0 that fits on chip, otherwise tile."""
    assert pfw.resolve_variant(variant, h, w) == want


def test_pair_warp_unknown_variant_raises():
    src, pair, mode = _pair_case(0)
    with pytest.raises(ValueError):
        pfw.fused_pair_warp(t(src), t(pair), t(mode), 1.0, 1.0,
                            variant="banded")


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_warp_bev_nhwc_matches(mode):
    """The gather warp, 1e-4: the frameworks round the affine chain
    differently (see WARP_ATOL); nearest compares away from ties."""
    rng = np.random.default_rng(5)
    feats = rng.standard_normal((2, 3, 16, 16, 8)).astype(np.float32)
    tf = rigid_pairwise(rng, 2, 3, max_t=6.0)[:, 0]
    want = np.asarray(jw.warp_bev_nhwc(feats, tf, 0.4, 4, mode))
    got = pw.warp_bev_nhwc(t(feats), t(tf), 0.4, 4, mode).numpy()
    assert got.shape == want.shape == feats.shape
    if mode == "nearest":
        assert np.mean(got == want) > 0.99
    else:
        close(got, want, WARP_ATOL)


def test_prep_affines_flags():
    """The kernel's coefficient rows: identity pairs flagged for copy,
    the conditioning swap set near 90 degrees, non-finite pairs zeroed."""
    _, pair, mode = _pair_case(1, angles=[0.0, np.pi / 2 + 1e-3, 0.3])
    pair = pair.copy()
    pair[0, 2, 0] = np.nan  # sender 2 -> receiver 0 broken
    coef, rtype = pfw._prep_affines(t(pair), t(mode), (H, H), 1.0, 1.0)
    assert coef.shape == (3, 3, 8) and rtype.tolist() == mode[0].tolist()
    flags = coef[..., 7].numpy()
    assert np.all(np.diag(flags) == 1.0)            # i == j copies
    assert flags[0, 2] == 2.0                       # invalid -> zeros
    assert coef[0, 1, 6] == 1.0 and coef[1, 0, 6] == 1.0  # ~90 deg swap
    assert torch.isfinite(coef).all()


@pytest.mark.parametrize("receivers", [None, 1])
def test_frame_coefficients_equal_per_launch_prep(receivers):
    """A frame's shared pair_warp_coefficients, sliced to the launch's
    receivers, are the tables the launch would compute for itself."""
    _, pair, mode = _pair_case(1, angles=[0.0, np.pi / 2 + 1e-3, 0.3])
    frame = pfw.pair_warp_coefficients(t(pair), (H, H), 1.0, 1.0)
    assert frame.shape == (B, L, L, 8) and frame.dtype == torch.float32
    own = pfw._prep_affines(t(pair), t(mode), (H, H), 1.0, 1.0, receivers)
    shared = pfw._prep_affines(t(pair), t(mode), (H, H), 1.0, 1.0,
                               receivers, frame)
    for a, b in zip(own, shared):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        pfw.pair_warp_launch(t(_pair_case(1)[0]), t(pair), t(mode), 1.0,
                             1.0, receivers, frame[:, :1])


def test_pair_warp_grad_recomputes_through_twin():
    src, pair, mode = _pair_case(0)
    s = t(src).requires_grad_()
    pfw.fused_pair_warp(s, t(pair), t(mode), 1.0, 1.0).square().sum() \
        .backward()
    assert s.grad is not None and torch.isfinite(s.grad).all()


@pytest.mark.parametrize("bad", ["pairwise_shape", "mode_shape",
                                 "receivers", "variant_range"])
def test_pair_warp_launch_rejects_malformed_inputs(bad):
    """The kernel wrapper checks, before any pointer reaches the device,
    everything the kernel indexes with (these checks run on any device;
    no kernel is built)."""
    src, pair, mode = _pair_case(0)
    receivers = None
    if bad == "pairwise_shape":
        pair = pair[:, :2]
    elif bad == "mode_shape":
        mode = mode[:, :2]
    elif bad == "receivers":
        receivers = L + 1
    else:
        mode = mode.copy()
        mode[0, 1] = 2  # src has 2 type variants
    err = RuntimeError if bad == "variant_range" else ValueError
    with pytest.raises(err):
        pfw.pair_warp_launch(t(src), t(pair), t(mode), 1.0, 1.0, receivers)


def test_kernel_launch_rejects_host_and_strided_tensors():
    """No host pointer or non-contiguous buffer reaches a CUDA kernel:
    the launcher refuses them before it builds or binds anything."""
    from hmvit_tpu_torch.ops import cuda

    before = cuda.launch_counts()
    with pytest.raises(ValueError):
        cuda.PAIR_WARP.launch([torch.zeros(4, 8)], [])
    with pytest.raises(ValueError):
        cuda.PLAIN_WINDOW_ATTENTION.launch([torch.zeros(4, 8).t()], [])
    assert cuda.launch_counts() == before
