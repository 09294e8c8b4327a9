"""The port's ``AnchorPostprocessor.post_process`` against the JAX
package's on the same outputs: one agent (decode, device NMS, range
clip) and three agents in other poses merged by the joint host NMS.  The
kept sets must be equal, corners within 1e-5 and scores within 1e-6
(float32 decode on both sides); and ``build_postprocessor`` routes the
anchor decode, while the anchor-free one is refused until ported."""
import numpy as np
import pytest
import torch

from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
from hmvit_tpu.postprocess import build_postprocessor as jbuild
from hmvit_tpu_torch.postprocess import AnchorPostprocessor, \
    build_postprocessor
from hmvit_tpu_torch.utils.transforms import pose_to_world
from tiny_cfg import ANCHOR_ARGS
from tiny_cfg import POSTPROCESS_CFG as TINY_POSTPROCESS_CFG

# the tiny model's postprocess config on a 32^2 pillar grid: 128 anchors,
# so that a CPU decode (a 128 x 128 rotated IoU) stays quick
POSTPROCESS_CFG = dict(TINY_POSTPROCESS_CFG,
                       anchor_args=dict(ANCHOR_ARGS, W=32, H=32))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def outputs(rng, a, h, w):
    """Logits with about a fifth of the anchors over the threshold, and
    small regression deltas (car-sized boxes near their anchors)."""
    psm = rng.normal(-1.8, 1.2, (1, a, h, w)).astype(np.float32)
    rm = (0.3 * rng.standard_normal((1, 7 * a, h, w))).astype(np.float32)
    return psm, rm


def same_boxes(got, want):
    """The same kept set: equal counts; matched by score order, corners
    within 1e-5 and scores within 1e-6."""
    (gc, gs), (wc, ws) = got, want
    if wc is None:
        assert gc is None and gs is None
        return 0
    assert gc.shape == wc.shape and gs.shape == ws.shape
    gi = np.lexsort((gc[:, 0, 1], gc[:, 0, 0], gs))
    wi = np.lexsort((wc[:, 0, 1], wc[:, 0, 0], ws))
    np.testing.assert_allclose(gs[gi], ws[wi], atol=1e-6, rtol=0)
    np.testing.assert_allclose(gc[gi], wc[wi], atol=1e-5, rtol=0)
    return len(gs)


@pytest.mark.parametrize("seed", [0, 1])
def test_post_process_one_agent_equals_jax(seed):
    rng = np.random.default_rng(seed)
    pp, jpp = AnchorPostprocessor(POSTPROCESS_CFG), \
        JPostprocessor(POSTPROCESS_CFG)
    anchors = pp.generate_anchor_box()
    h, w, a = anchors.shape[:3]
    psm, rm = outputs(rng, a, h, w)
    tf = pose_to_world([3.0, -2.0, 0.0, 0.0, 25.0, 0.0])
    for no_proj in (True, False):
        data = {0: {"transformation_matrix": tf, "anchor_box": anchors,
                    "no_post_projection": no_proj}}
        got = pp.post_process(data, {0: {"psm": torch.from_numpy(psm),
                                         "rm": torch.from_numpy(rm)}})
        want = jpp.post_process(data, {0: {"psm": psm, "rm": rm}})
        assert same_boxes(got, want) > 2
    # numpy outputs are taken as they are; no agent answering -> None
    got = pp.post_process(data, {0: {"psm": psm, "rm": rm}})
    same_boxes(got, jpp.post_process(data, {0: {"psm": psm, "rm": rm}}))
    assert pp.post_process(data, {}) == (None, None)
    dead = {0: {"psm": np.full_like(psm, -20.0), "rm": rm}}
    assert pp.post_process(data, dead) == (None, None) == \
        jpp.post_process(data, dead)


def test_post_process_three_agents_joint_nms_equals_jax():
    """Three agents, two of them seeing the same boxes from nearly the
    same pose: the joint NMS across agents removes the duplicates."""
    rng = np.random.default_rng(2)
    pp, jpp = AnchorPostprocessor(POSTPROCESS_CFG), \
        JPostprocessor(POSTPROCESS_CFG)
    anchors = pp.generate_anchor_box()
    h, w, a = anchors.shape[:3]
    poses = [[0.0, 0.0, 0.0, 0.0, 0.0, 0.0], [0.3, 0.2, 0.0, 0.0, 1.0, 0.0],
             [12.0, -8.0, 0.0, 0.0, 70.0, 0.0]]
    psm, rm = outputs(rng, a, h, w)
    # agent 1's scores a little off agent 0's: no exact ties between the
    # duplicates, whose order float32 noise would decide
    outs = [(psm, rm), (psm + 0.01, rm), outputs(rng, a, h, w)]
    data = {i: {"transformation_matrix": np.linalg.inv(pose_to_world(
        poses[0])) @ pose_to_world(p), "anchor_box": anchors}
        for i, p in enumerate(poses)}
    got = pp.post_process(data, {i: {"psm": torch.from_numpy(p),
                                     "rm": torch.from_numpy(r)}
                                 for i, (p, r) in enumerate(outs)})
    want = jpp.post_process(data, {i: {"psm": p, "rm": r}
                                   for i, (p, r) in enumerate(outs)})
    kept = same_boxes(got, want)
    single = sum(len(pp.post_process({i: data[i]}, {i: {
        "psm": torch.from_numpy(p), "rm": torch.from_numpy(r)}})[0])
        for i, (p, r) in enumerate(outs))
    assert 0 < kept < single  # the joint NMS merged across agents


def test_build_postprocessor_routes_the_anchor_decode():
    for cfg in (POSTPROCESS_CFG,
                dict(POSTPROCESS_CFG, core_method="VoxelPostprocessor")):
        pp = build_postprocessor(cfg, train=False)
        assert isinstance(pp, AnchorPostprocessor)
        assert type(jbuild(cfg, train=False)).__name__ == \
            type(pp).__name__
        assert pp.train is False and pp.order == "hwl"
    # the anchor-free decode of the PIXOR family
    bev = dict(POSTPROCESS_CFG, core_method="BevPostprocessor",
               geometry_param={"res": 0.4, "downsample_rate": 4})
    pp = build_postprocessor(bev, train=False)
    assert type(pp).__name__ == type(jbuild(bev, train=False)).__name__ \
        == "BevPostprocessor"
    assert pp.generate_anchor_box() is None and pp.order == "hwl"
