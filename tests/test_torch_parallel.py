"""Data, tensor and spatial parallelism (``hmvit_tpu_torch/parallel``) on
gloo CPU processes, against the single-process port and the JAX package
(the counterparts of ``tests/test_trainer_sharding.py``, at its shapes
and bars).  Each layout is spawned once (``tests/torch_parallel_workers
.py``, a ``FileStore`` in the test's directory): a 1-D data mesh of 2
ranks, a world of 4 holding a 1-D data mesh and a (2, 2) ``("data",
"model")`` mesh, and a world of 3 holding a (1, 3) mesh.

* DP (2 and 4 ranks): the step's loss equals the single-process step's
  at rtol 2e-4, the parameters and the global BatchNorm statistics after
  it at 1e-5; the loss decreases over 6 DP steps.
* DP x TP (2 x 2): the first loss within rtol 3e-4 of the single step's,
  decreasing over 3 steps; the audit finds no miss; at least 8 leaves
  split, still split after the steps; the checkpoint rank 0 writes has
  the single-process layout and restores into a single model.
* Dropout 0.1 in the fusion: the first DP (2 ranks) and DP x TP (2 x 2)
  step's loss equals the single-process step's at the same bars (every
  rank keeps its block of the single process's masks).
* DP x TP (2 x 2) at 3 heads of 16 (the heads do not split over mp = 2;
  the projections are gathered to whole heads; the serving path's static
  [K|V] fold within 1e-5 of the general path) and with the FAX reference
  twin as camera encoder (its plain ``Dense`` to_q / to_k / to_v split
  by columns, as JAX's rules split the flax kernels; no warning, the
  audit's hits): the first step's loss, and the gathered parameters
  after it, as the DP step's against the single-process step; the twin's
  gathered checkpoint has the single-process layout and restores.
* V2X-ViT under DP x TP (its HGT attention's typed projections split,
  gathered to whole heads): the first step as the DP step's against the
  single-process step.
* The TP rules mark the same leaves as JAX's on the same model, the tiny
  one and the two reference twins' (JAX's function on the flax tree's
  ``keystr``, the port's on its state-dict names, paired through
  ``bridge.py``), and cut the same values: each rank's slice of a port
  leaf, converted to flax's layout, is JAX's slice of the flax leaf.
* Sharded eval: psm within 1e-4 of the per-frame forward, the same AP.
* Spatial eval (mp = 2): the tiny configuration within 1e-4 of the
  unsharded port forward and of the JAX unsharded forward at the same
  weights, with JAX's warning for the local phase (h = 16 breaks the
  island's preconditions); the island configuration (fusion maps 64^2,
  shards of 32 rows) within 2e-3, the island taken (only the grid phase
  warns).  Spatial eval over 3 shards (mp = 3) of the tiny configuration's
  16-row map (rows that do not split evenly: padded, as GSPMD pads):
  within 1e-4 of the unsharded port and JAX forwards, every phase taking
  the fallback with JAX's warning.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_parallel_workers as W
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu.parallel import mesh as jmesh
from hmvit_tpu_torch import bridge, parallel
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.train.checkpointing import restore_checkpoint
from hmvit_tpu_torch.train.schedulers import build_optimizer
from hmvit_tpu_torch.train.trainer import create_train_state
from hmvit_tpu_torch.utils import evaluation as E
from hmvit_tpu_torch.utils.boxes import boxes_to_corners_3d_np
from tiny_cfg import POSTPROCESS_CFG, TINY_CFG
from torch_parity import close


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


class Run:
    """One layout spawned over ``world`` gloo ranks; ``run(name)`` loads
    what rank 0 saved, ``run.dir`` is its directory."""

    def __init__(self, fn, world, tmp_path_factory, name):
        self.dir = str(tmp_path_factory.mktemp(name))
        mp.spawn(fn, args=(world, self.dir, self.dir), nprocs=world,
                 join=True)

    def __call__(self, what):
        return torch.load(os.path.join(self.dir, what + ".pt"),
                          weights_only=False)


@pytest.fixture(scope="module")
def data_run(tmp_path_factory):
    return Run(W.layout_data, 2, tmp_path_factory, "dp")


@pytest.fixture(scope="module")
def hybrid_run(tmp_path_factory):
    return Run(W.layout_hybrid, 4, tmp_path_factory, "hybrid")


@pytest.fixture(scope="module")
def uneven_run(tmp_path_factory):
    return Run(W.layout_uneven, 3, tmp_path_factory, "uneven")


@pytest.fixture(scope="module")
def single():
    torch.set_num_threads(1)
    return W.single_reference()


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_runs_and_matches_single(world, data_run,
                                                    hybrid_run, single):
    run = (data_run if world == 2 else hybrid_run)(f"dp{world}")
    assert_step_matches(run, single, rtol=2e-4)


def assert_step_matches(run, single, rtol, floor=0.0):
    """The first step's loss at ``rtol``; the parameters after it at 1e-5
    where the two gradients agree in sign and both exceed ``floor`` in
    magnitude, the rest within Adam's 2 lr, and the statistics at 1e-5.
    A ``floor`` of 1e-8 (100 times Adam's eps) leaves out the gradients at
    rounding level, whose first Adam step lr |g| / (|g| + eps) is not yet
    lr: a LayerNorm bias ahead of a key projection has a true gradient of
    0 (softmax does not see a shift shared by every key), so either run's
    step there is rounding noise normalised."""
    assert np.isfinite(run["losses"][0])
    np.testing.assert_allclose(run["losses"][0], single["losses"][0],
                               rtol=rtol)
    flipped = total = 0
    for key, want in single["after"].items():
        got = run["after"][key]
        if key not in single["grads"]:
            # the running statistics of the global batch
            close(got.numpy(), want.numpy(), 1e-5)
            continue
        # Adam's first step moves an element by lr * sign(grad): where the
        # two gradients' signs differ (a gradient at rounding level) the
        # element lands 2 lr away (as in tests/test_torch_train_step.py);
        # every other element at 1e-5
        same = torch.sign(run["grads"][key]) == torch.sign(
            single["grads"][key])
        steady = same if floor == 0 else same & (
            run["grads"][key].abs() > floor) & (
            single["grads"][key].abs() > floor)
        close(got[steady].numpy(), want[steady].numpy(), 1e-5)
        close(got.numpy(), want.numpy(), 2 * W.SCHED_CFG["warmup_lr"] + 1e-5)
        flipped += int((~same).sum())
        total += same.numel()
    assert flipped <= 1e-3 * total, (flipped, total)


def test_loss_decreases_under_dp(data_run):
    losses = data_run("dp2")["losses"]
    assert len(losses) == 6 and losses[-1] < losses[0], losses


def test_hybrid_dp_tp_step_matches_single(hybrid_run, single):
    run = hybrid_run("hybrid")
    losses = run["losses"]
    np.testing.assert_allclose(losses[0], single["losses"][0], rtol=3e-4)
    assert losses[-1] < losses[0], losses
    assert run["miss"] == [], run["miss"]
    assert run["split"] >= 8, "TP rules matched too few fusion params"
    assert run["still"] >= run["split"]
    # the checkpoint is the single-process layout and restores into it
    model = init_parameters(HMViT(TINY_CFG), 0)
    opt, _ = build_optimizer(model, W.OPT_CFG, W.SCHED_CFG, 10)
    saved = torch.load(os.path.join(hybrid_run.dir, "ckpt", "3",
                                    "state.pt"), weights_only=True)
    want = model.state_dict()
    assert list(saved["model"]) == list(want)
    for key, v in want.items():
        assert saved["model"][key].shape == v.shape, key
    state = restore_checkpoint(os.path.join(hybrid_run.dir, "ckpt"),
                               create_train_state(model, opt))
    assert state.step == 3


@pytest.fixture(scope="module")
def single_dropout():
    torch.set_num_threads(1)
    return W.single_reference(W.DROPOUT_CFG)


@pytest.mark.parametrize("layout,rtol", [("dp2", 2e-4), ("hybrid", 3e-4)])
def test_dropout_step_matches_single(layout, rtol, data_run, hybrid_run,
                                     single, single_dropout):
    run = data_run if layout == "dp2" else hybrid_run
    got = run(f"{layout}_dropout")["losses"][0]
    want = single_dropout["losses"][0]
    # the masks change the loss, and every rank's block of them is the
    # single process's
    assert abs(want - single["losses"][0]) > 10 * rtol * abs(want)
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_tp_within_heads_step_matches_single(hybrid_run):
    """3 heads over mp = 2: JAX's layout splits the projections' 48
    columns 24 a rank, and the step equals the single-process step."""
    run = hybrid_run("heads3")
    assert_step_matches(run, W.single_reference(W.HEADS3_CFG), rtol=3e-4)
    assert run["losses"][-1] < run["losses"][0], run["losses"]
    assert run["miss"] == [] and len(run["hit"]) >= 8, run
    attn = "fusion.HeteroFusionBlock_0.window_attn"
    assert run["tp_axes"][f"{attn}.to_q.kernel"] == 2
    assert run["tp_axes"][f"{attn}.to_out.kernel"] == 1
    assert not run["warnings"], run["warnings"]
    # the serving path's static [K|V] fold on the gathered whole heads
    for key in ("psm", "rm"):
        close(run["folded"][key].numpy(), run["plain"][key].numpy(), 1e-5)


def test_tp_splits_the_reference_twin_dense(hybrid_run):
    """The FAX twin's to_q / to_k / to_v ``Dense`` (weight (16, 32)) are
    split by their output rows, as JAX splits the flax kernels' columns;
    no warning; the step equals the single-process step; the gathered
    checkpoint is the single-process layout and restores."""
    run = hybrid_run("fax_ref")
    dense = {k: a for k, a in run["tp_axes"].items()
             if k.startswith("camera_encoder.")}
    assert len(dense) == 12, dense
    assert all(k.rsplit(".", 2)[-2] in ("to_q", "to_k", "to_v")
               and k.endswith(".weight") and a == 0
               for k, a in dense.items()), dense
    assert set(dense) <= set(run["hit"]) and run["miss"] == [], run
    assert not run["warnings"], run["warnings"]
    assert_step_matches(run, W.single_reference(W.FAX_REF_CFG), rtol=3e-4,
                        floor=1e-8)
    model = init_parameters(HMViT(W.FAX_REF_CFG), 0)
    opt, _ = build_optimizer(model, W.OPT_CFG, W.SCHED_CFG, 10)
    saved = torch.load(os.path.join(hybrid_run.dir, "ckpt_fax_ref", "2",
                                    "state.pt"), weights_only=True)
    want = model.state_dict()
    assert list(saved["model"]) == list(want)
    for key, v in want.items():
        assert saved["model"][key].shape == v.shape, key
    state = restore_checkpoint(os.path.join(hybrid_run.dir, "ckpt_fax_ref"),
                               create_train_state(model, opt))
    assert state.step == 2


def test_tp_v2xvit_step_matches_single(hybrid_run):
    """V2X-ViT under DP x TP (its HGT attention's typed projections split
    by JAX's rules, gathered to whole heads, the message split again for
    to_out): the step equals the single-process step."""
    run = hybrid_run("v2xvit_tp")
    hgt = [k for k in run["tp_axes"] if ".HGTCavAttention_0." in k]
    assert len(hgt) >= 7, run["tp_axes"]
    assert not run["warnings"], run["warnings"]
    assert_step_matches(run, W.single_reference(W.V2XVIT_CFG), rtol=3e-4)


RULE_MODELS = {"tiny": TINY_CFG, "fax_ref": W.FAX_REF_CFG,
               "cvt_ref": dict(TINY_CFG, camera=dict(
                   TINY_CFG["camera"], encoder="cvt_ref", heads=2,
                   dim_head=8, middle=[1, 1]))}


@pytest.mark.parametrize("mp_size", [2, 4])
def test_tp_rules_mark_the_same_leaves_as_jax(mp_size):
    for name in sorted(RULE_MODELS):
        tp_rules_case(mp_size, name)


def tp_rules_case(mp_size, name):
    model = init_parameters(HMViT(RULE_MODELS[name]), 0)
    sd = model.state_dict()
    variables = bridge.state_dict_to_flax(model, sd)
    leaves, jax_specs = {}, {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            variables["params"])[0]:
        pstr = jax.tree_util.keystr(path)
        leaves[pstr] = leaf
        jax_specs[pstr] = tuple(jmesh.tp_spec_for_path(pstr, leaf.shape,
                                                       mp_size))
    marked = dense = 0
    for key, v in sd.items():
        (coll, *path), kind = bridge._flax_source(model, key)
        if coll != "params":
            continue
        pstr = "".join(f"['{p}']" for p in path)
        want = jax_specs[pstr]
        got = parallel.tp_spec_for_path(key, tuple(v.shape), mp_size, kind)
        assert ("model" in got) == ("model" in want), key
        if "model" not in want:
            continue
        if kind == "copy":
            assert got == want, key
        # each rank's slice of the port leaf, in flax's layout, is JAX's
        # slice of the flax leaf
        for part, jpart in zip(
                np.array_split(v.numpy(), mp_size, got.index("model")),
                np.array_split(leaves[pstr], mp_size, want.index("model"))):
            np.testing.assert_array_equal(bridge._unconvert(part, kind),
                                          jpart, err_msg=key)
        marked += 1
        dense += kind == "dense"
    assert marked >= 8
    assert dense == (0 if name == "tiny" else 12 if name == "fax_ref"
                     else 6), dense


def frame_ap(pp, anchors, batch, psm_all, rm_all):
    stat = E.new_result_stat("both")
    for i in range(psm_all.shape[0]):
        corners, scores = pp.post_process(
            {"ego": {"transformation_matrix": np.eye(4),
                     "anchor_box": anchors, "no_post_projection": True}},
            {"ego": {"psm": psm_all[i:i + 1], "rm": rm_all[i:i + 1]}})
        gt_mask = batch["object_bbx_mask"][i].numpy() > 0
        gt = boxes_to_corners_3d_np(
            batch["object_bbx_center"][i].numpy()[gt_mask], pp.order)
        E.accumulate_frame(corners, scores, gt, stat)
    return E.final_results(stat)


def test_sharded_eval_matches_single_device_ap(data_run):
    got = data_run("sharded_eval")
    model = init_parameters(HMViT(TINY_CFG), 0)
    batch = W.make_batch(8)
    with torch.no_grad():
        per_frame = [model({k: v[i:i + 1] for k, v in batch.items()})
                     for i in range(8)]
    psm = torch.cat([o["psm"] for o in per_frame])
    rm = torch.cat([o["rm"] for o in per_frame])
    close(got["psm"].numpy(), psm.numpy(), 1e-4)
    pp = AnchorPostprocessor(POSTPROCESS_CFG, train=False)
    anchors = pp.generate_anchor_box()
    assert frame_ap(pp, anchors, batch, psm, rm) == \
        frame_ap(pp, anchors, batch, got["psm"], got["rm"])


def unsharded(cfg, frames, seed):
    model = init_parameters(HMViT(cfg), 4)
    batch = W.make_batch(frames, seed=seed)
    with torch.no_grad():
        return model, batch, model(batch)


@pytest.fixture(scope="module")
def tiny_unsharded():
    """The tiny configuration's unsharded forward of 8 frames, the port's
    and the JAX package's at the same weights."""
    torch.set_num_threads(1)
    model, batch, want = unsharded(TINY_CFG, 8, 0)
    variables = bridge.state_dict_to_flax(model, model.state_dict())
    jout = jax.jit(lambda v, b: JHMViT(TINY_CFG).apply(v, b, train=False))(
        variables, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    return want, {k: np.asarray(v) for k, v in jout.items()}


def test_spatial_eval_matches_unsharded(hybrid_run, tiny_unsharded):
    """Over 2 shards of 8 rows."""
    spatial_case(hybrid_run("spatial_tiny"), tiny_unsharded, 2)


def test_spatial_eval_uneven_rows_matches_unsharded(uneven_run,
                                                    tiny_unsharded):
    """Over 3 shards of the 16 rows: 6, 6 and 4 rows, 2 of padding."""
    spatial_case(uneven_run("spatial_uneven"), tiny_unsharded, 3)


def spatial_case(run, tiny_unsharded, shards):
    want, jout = tiny_unsharded
    for key in ("psm", "rm"):
        close(run["out"][key].numpy(), want[key].numpy(), 1e-4)
    # the JAX package's unsharded forward at the same weights
    for key in ("psm", "rm"):
        close(run["out"][key].numpy(), jout[key], 1e-4)
    local = [w for w in run["warnings"]
             if w.startswith("SP fallback: local attention phase")]
    assert local and "island preconditions not met" in local[0], \
        run["warnings"]
    fallbacks = [w for w in run["warnings"] if w.startswith("SP fallback")]
    assert any(w.startswith("SP fallback: grid attention phase")
               for w in fallbacks), fallbacks
    assert all(f"shards={shards}" in w for w in fallbacks), fallbacks


def test_spatial_eval_pallas_island(hybrid_run):
    run = hybrid_run("spatial_island")
    _, _, want = unsharded(W.ISLAND_CFG, 4, 3)
    for key in ("psm", "rm"):
        close(run["out"][key].numpy(), want[key].numpy(), 2e-3)
    assert not any("local attention phase" in w for w in run["warnings"]), \
        run["warnings"]
    assert any(w.startswith("SP fallback: grid attention phase at h=64")
               for w in run["warnings"]), run["warnings"]
