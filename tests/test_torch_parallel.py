"""Data, tensor and spatial parallelism (``hmvit_tpu_torch/parallel``) on
gloo CPU processes, against the single-process port and the JAX package
(the counterparts of ``tests/test_trainer_sharding.py``, at its shapes
and bars).  Each layout is spawned once (``tests/torch_parallel_workers
.py``, a ``FileStore`` in the test's directory): a 1-D data mesh of 2
ranks, and a world of 4 holding a 1-D data mesh and a (2, 2) ``("data",
"model")`` mesh.

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
* The TP rules mark the same leaves as JAX's on the same model (JAX's
  function on the flax tree's ``keystr``, the port's on its state-dict
  names, paired through ``bridge.py``).
* Sharded eval: psm within 1e-4 of the per-frame forward, the same AP.
* Spatial eval (mp = 2): the tiny configuration within 1e-4 of the
  unsharded port forward and of the JAX unsharded forward at the same
  weights, with JAX's warning for the local phase (h = 16 breaks the
  island's preconditions); the island configuration (fusion maps 64^2,
  shards of 32 rows) within 2e-3, the island taken (only the grid phase
  warns).
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
def single():
    torch.set_num_threads(1)
    return W.single_reference()


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_step_runs_and_matches_single(world, data_run,
                                                    hybrid_run, single):
    run = (data_run if world == 2 else hybrid_run)(f"dp{world}")
    assert np.isfinite(run["losses"][0])
    np.testing.assert_allclose(run["losses"][0], single["losses"][0],
                               rtol=2e-4)
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
        close(got[same].numpy(), want[same].numpy(), 1e-5)
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


@pytest.mark.parametrize("mp_size", [2, 4])
def test_tp_rules_mark_the_same_leaves_as_jax(mp_size):
    model = init_parameters(HMViT(TINY_CFG), 0)
    sd = model.state_dict()
    variables = bridge.state_dict_to_flax(model, sd)
    jax_specs = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            variables["params"])[0]:
        jax_specs[jax.tree_util.keystr(path)] = tuple(
            jmesh.tp_spec_for_path(jax.tree_util.keystr(path), leaf.shape,
                                   mp_size))
    marked = 0
    for key, v in sd.items():
        coll, *path = bridge._flax_source(model, key)[0]
        if coll != "params":
            continue
        want = jax_specs["".join(f"['{p}']" for p in path)]
        got = parallel.tp_spec_for_path(key, tuple(v.shape), mp_size)
        assert ("model" in got) == ("model" in want), key
        if "model" in want:
            assert got == want, key
            marked += 1
    assert marked >= 8


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


def test_spatial_eval_matches_unsharded(hybrid_run):
    run = hybrid_run("spatial_tiny")
    model, batch, want = unsharded(TINY_CFG, 8, 0)
    for key in ("psm", "rm"):
        close(run["out"][key].numpy(), want[key].numpy(), 1e-4)
    # the JAX package's unsharded forward at the same weights
    variables = bridge.state_dict_to_flax(model, model.state_dict())
    jout = jax.jit(lambda v, b: JHMViT(TINY_CFG).apply(v, b, train=False))(
        variables, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    for key in ("psm", "rm"):
        close(run["out"][key].numpy(), np.asarray(jout[key]), 1e-4)
    local = [w for w in run["warnings"]
             if w.startswith("SP fallback: local attention phase")]
    assert local and "island preconditions not met" in local[0], \
        run["warnings"]


def test_spatial_eval_pallas_island(hybrid_run):
    run = hybrid_run("spatial_island")
    _, _, want = unsharded(W.ISLAND_CFG, 4, 3)
    for key in ("psm", "rm"):
        close(run["out"][key].numpy(), want[key].numpy(), 2e-3)
    assert not any("local attention phase" in w for w in run["warnings"]), \
        run["warnings"]
    assert any(w.startswith("SP fallback: grid attention phase at h=64")
               for w in run["warnings"]), run["warnings"]
