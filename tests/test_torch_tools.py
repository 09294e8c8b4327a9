"""The port's run-directory tools on the CPU (``--cpu``), on
``smoke_hetero_tiny.yaml`` and the synthetic mini-OPV2V: the reference-free
cases of the JAX package's ``test_train_infra``, ``test_performance_cli``
and ``test_sweep`` — train writes a run directory and resumes it,
inference evaluates it under every fusion method, the sweep walks its
grid, the performance runner reports it — the intermediate AP of a
run directory equal to the JAX tool's on the same weights and frames, and
the performance runner's FLOP count: the counter's plus the hand-written
kernels' operation counts."""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hmvit_tpu.config import load_config as jload_config
from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu_torch.config import load_config, save_config
from hmvit_tpu_torch.data.codecs import yaml_load_file
from hmvit_tpu_torch.tools import inference, performance, sweep, train
from torch_parity import flax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "hmvit_tpu_torch", "config", "hypes",
                     "smoke_hetero_tiny.yaml")
SMALL = ["--max_points", "2048", "--cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A run directory trained 2 steps (one epoch) by the port's CLI."""
    torch.set_num_threads(1)
    run = str(tmp_path_factory.mktemp("tools") / "run")
    assert train.main(["--hypes_yaml", SMOKE, "--model_dir", run,
                       "--synthetic", "--epoches", "1",
                       "--steps_per_epoch", "2", "--num_workers", "2",
                       *SMALL]) == run
    return run


def test_train_writes_the_run_directory(run_dir):
    records = [json.loads(line) for line in
               open(os.path.join(run_dir, "metrics.jsonl"))]
    assert [(r["epoch"], r["step"]) for r in records] == [(0, 0)]
    assert all(np.isfinite(records[0][k])
               for k in ("total_loss", "conf_loss", "reg_loss", "lr"))
    assert os.path.isfile(os.path.join(run_dir, "ckpt", "1", "state.pt"))
    snap = load_config("", model_dir=run_dir)
    assert snap["model"] == load_config(SMOKE)["model"]
    assert snap["train_params"]["epoches"] == 1
    # the JAX loader reads the port's snapshot as the port does
    assert {k: v for k, v in jload_config("", model_dir=run_dir).items()
            if k != "fileDirname"} == \
        {k: v for k, v in snap.items() if k != "fileDirname"}


def test_train_resumes_from_the_last_epoch(run_dir, tmp_path, capsys):
    run = str(tmp_path / "run")
    shutil.copytree(run_dir, run)
    train.main(["--hypes_yaml", SMOKE, "--model_dir", run, "--synthetic",
                "--epoches", "2", "--steps_per_epoch", "1", *SMALL])
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert os.path.isfile(os.path.join(run, "ckpt", "2", "state.pt"))
    saved = torch.load(os.path.join(run, "ckpt", "2", "state.pt"),
                       weights_only=True)
    assert saved["step"] == 3  # the restored 2 steps and 1 more
    records = [json.loads(line) for line in
               open(os.path.join(run, "metrics.jsonl"))]
    assert [(r["epoch"], r["step"]) for r in records] == [(0, 0), (1, 0)]


def test_train_grafts_a_backbone_from_a_run_directory(run_dir, tmp_path):
    """``--lidar_backbone_dir``: the lidar encoder's weights come from the
    donor's last checkpoint, every other weight stays; a donor without a
    checkpoint grafts nothing."""
    from hmvit_tpu_torch.models.zoo import build_model
    from hmvit_tpu_torch.nn import init_parameters

    model = init_parameters(build_model(load_config(SMOKE)["model"]), 1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert not train.graft_backbone(model, "lidar_encoder", str(tmp_path))
    assert train.graft_backbone(model, "lidar_encoder", run_dir)
    donor = torch.load(os.path.join(run_dir, "ckpt", "1", "state.pt"),
                       weights_only=True)["model"]
    for k, v in model.state_dict().items():
        want = donor[k] if k.startswith("lidar_encoder.") else before[k]
        assert torch.equal(v, want), k


@pytest.mark.parametrize("method", ["intermediate", "no", "early", "late"])
def test_inference_every_fusion_method(run_dir, method):
    res = inference.main(["--model_dir", run_dir, "--synthetic",
                          "--max_frames", "3", "--fusion_method", method,
                          *SMALL])
    for k in ("ap_30", "ap_50", "ap_70"):
        assert 0.0 <= res["iou"][k] <= 1.0
    assert set(res["distance"]) == {"ap_0.5", "ap_1.0", "ap_2.0", "ap_4.0",
                                    "map"}
    assert res["e2e"]["frames"] == 2 and res["e2e"]["fps"] > 0
    assert res["e2e"]["p50_ms"] <= res["e2e"]["p95_ms"]
    back = yaml_load_file(os.path.join(run_dir, "eval.yaml"))
    assert back["iou"] == res["iou"]


def test_serving_buckets_give_the_plain_forward_boxes(run_dir, tmp_path):
    """Eager serving hints (the CPU's ``--serving_buckets``) against the
    run-both forward: the same boxes, the same AP."""
    preds = {}
    for flags in ([], ["--serving_buckets"]):
        run = str(tmp_path / f"run{len(flags)}")
        shutil.copytree(run_dir, run)
        res = inference.main(["--model_dir", run, "--synthetic",
                              "--max_frames", "2", "--save_npy",
                              "--ap_mode", "iou", *flags, *SMALL])
        preds[len(flags)] = (res["iou"], [
            np.load(os.path.join(run, "npy", f"{i:04d}_pred.npy"))
            for i in range(2)])
    assert preds[0][0] == preds[1][0]
    for a, b in zip(preds[0][1], preds[1][1]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4)


@pytest.mark.parametrize("argv,item", [
    (["--mp", "2"], "torchrun --nproc_per_node 2"),
])
def test_train_refuses_what_is_not_ported(argv, item, tmp_path):
    """``--mp 2`` in a world of one process: the fusion trunk cannot
    split, and the message names the launcher that makes the processes."""
    with pytest.raises(SystemExit, match=item):
        train.main(["--hypes_yaml", SMOKE, "--model_dir",
                    str(tmp_path / "r"), *argv, *SMALL])


def test_train_refuses_the_segmentation_task(tmp_path):
    """The segmentation loss on a detector (no BEV seg heads) is refused
    by name (the JAX tool fails on the missing output's key)."""
    params = load_config(SMOKE)
    params["loss"] = {"core_method": "seg_loss", "args": {}}
    save_config(params, str(tmp_path / "seg.yaml"))
    with pytest.raises(ValueError, match="segmentation heads"):
        train.main(["--hypes_yaml", str(tmp_path / "seg.yaml"),
                    "--model_dir", str(tmp_path / "r"), "--synthetic",
                    *SMALL])


@pytest.mark.parametrize("flag", ["--data_parallel"])
def test_inference_refuses_what_is_not_ported(run_dir, flag, tmp_path):
    """``--data_parallel`` in a world of one process serves the frames one
    a round and gives the serial run's AP (it refused before the port of
    ``parallel/``); it takes intermediate fusion only."""
    results = {}
    for flags in ([], [flag]):
        run = str(tmp_path / f"run{len(flags)}")
        shutil.copytree(run_dir, run)
        results[len(flags)] = inference.main(
            ["--model_dir", run, "--synthetic", "--max_frames", "2",
             *flags, *SMALL])
    assert results[1]["iou"] == results[0]["iou"]
    assert results[1]["distance"] == results[0]["distance"]
    with pytest.raises(SystemExit, match="intermediate fusion only"):
        inference.main(["--model_dir", run_dir, flag, "--fusion_method",
                        "late", *SMALL])


def torchrun(module, *argv):
    """``torchrun --standalone --nproc_per_node 2 -m module argv`` (gloo on
    the CPU): its output, after a zero exit."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", module, *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_two_ranks_train_mp2_and_serve_data_parallel(run_dir, tmp_path):
    """Two gloo processes under the launcher: ``tools.train --mp 2`` (the
    fusion trunk split over both) writes a checkpoint in the
    single-process layout, and ``tools.inference --data_parallel`` on it
    gives the serial run's AP."""
    run = str(tmp_path / "mp2")
    out = torchrun("hmvit_tpu_torch.tools.train", "--hypes_yaml", SMOKE,
                   "--model_dir", run, "--synthetic", "--epoches", "1",
                   "--steps_per_epoch", "2", "--mp", "2", *SMALL)
    assert out.count("training done") == 1  # rank 0 reports
    saved = torch.load(os.path.join(run, "ckpt", "1", "state.pt"),
                       weights_only=True)
    single = torch.load(os.path.join(run_dir, "ckpt", "1", "state.pt"),
                        weights_only=True)
    assert {k: v.shape for k, v in saved["model"].items()} == \
        {k: v.shape for k, v in single["model"].items()}
    assert saved["step"] == 2
    torchrun("hmvit_tpu_torch.tools.inference", "--model_dir", run,
             "--synthetic", "--max_frames", "3", "--data_parallel", *SMALL)
    shared = yaml_load_file(os.path.join(run, "eval.yaml"))
    serial = inference.main(["--model_dir", run, "--synthetic",
                             "--max_frames", "3", *SMALL])
    assert shared["iou"] == serial["iou"]


@pytest.mark.parametrize("flag", ["--save_vis", "--save_3d"])
def test_inference_writes_the_visualizations(run_dir, tmp_path, flag):
    """``--save_vis``: one BEV PNG a frame, of the image shape of the
    config's range; ``--save_3d``: ``sequence.html`` with one frame a
    served frame.  Neither is written without its flag."""
    from hmvit_tpu_torch.data.codecs import read_png
    from hmvit_tpu_torch.visualization.vis import bev_shape

    run = str(tmp_path / "run")
    shutil.copytree(run_dir, run)
    inference.main(["--model_dir", run, "--synthetic", "--synthetic_frames",
                    "2", "--ap_mode", "iou", flag, *SMALL])
    pngs = sorted(os.listdir(os.path.join(run, "vis"))) \
        if os.path.isdir(os.path.join(run, "vis")) else []
    html = os.path.join(run, "sequence.html")
    if flag == "--save_vis":
        assert pngs == ["00000.png", "00001.png"] and not os.path.exists(html)
        shape = bev_shape(load_config(SMOKE)["preprocess"]["cav_lidar_range"])
        for name in pngs:
            img = read_png(os.path.join(run, "vis", name))
            assert img.shape == (*shape, 3) and img.any()
    else:
        assert pngs == [] and os.path.exists(html)
        text = open(html).read()
        frames = json.loads(text.split("FRAMES=")[1].split(", EDGES=")[0])
        assert len(frames) == 2 and all(len(f["pts"]) > 0 for f in frames)


def test_tools_need_the_card_without_cpu(run_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="--cpu"):
        inference.main(["--model_dir", run_dir])


def test_sweep_writes_the_non_degenerate_cells(run_dir, tmp_path):
    run = str(tmp_path / "run")
    shutil.copytree(run_dir, run)
    grid = sweep.main(["--model_dir", run, "--ratios", "0,1",
                       "--ego_modes", "lidar,camera", "--synthetic",
                       "--max_frames", "2", "--ap_mode", "iou", *SMALL])
    assert set(grid) == {"ratio=0,ego=lidar", "ratio=1,ego=camera"}
    data = json.load(open(os.path.join(run, "sweep.json")))
    assert set(data) == set(grid)
    for cell, res in data.items():
        for k in ("ap_30", "ap_50", "ap_70"):
            assert np.isfinite(res["iou"][k]) and 0 <= res["iou"][k] <= 1


def _jax_variables(params, frame_batch):
    """Seeded flax variables of the run directory's JAX model, their
    score bias at 0 so that many anchors pass the score threshold."""
    jm = JHMViT(params["model"]["args"])
    jb = {k: jnp.asarray(v) for k, v in frame_batch.items()
          if k not in ("object_ids", "to_ego")}
    v = jax.tree_util.tree_map(np.array, flax_variables(jm, jb, train=False,
                                                        seed=5))
    for head in ("camera_head", "lidar_head"):
        conv = v["params"]["HeteroDecoder_0"][head]["Conv_0"]
        conv["bias"] = np.zeros_like(conv["bias"])
    return jm, jb, v


def test_performance_report_params_equal_jax(run_dir, tmp_path):
    from hmvit_tpu_torch.data.opv2v import HeteroCooperativeDataset
    from hmvit_tpu_torch.tools.common import write_synthetic

    trace = str(tmp_path / "trace")
    report = performance.main(["--model_dir", run_dir, "--synthetic",
                               "--iters", "2", "--trace_dir", trace,
                               *SMALL])
    params = load_config("", model_dir=run_dir)
    write_synthetic(params, "perf_test_", 2048, num_scenarios=1,
                    num_cavs=2, num_frames=1)
    ds = HeteroCooperativeDataset(params, train=False, max_points=2048)
    _, _, v = _jax_variables(params, ds.collate_batch([ds[0]]))
    n_flax = sum(int(np.prod(x.shape))
                 for x in jax.tree_util.tree_leaves(v["params"]))
    assert report["params"] == n_flax
    assert report["params_million"] == round(n_flax / 1e6, 3)
    assert report["flops_per_frame"] > 0 and report["gmacs"] > 0
    assert report["fps"] > 0 and report["device"] == "cpu"
    assert os.listdir(trace)
    from hmvit_tpu_torch.tools import profile as profile_tool

    profile_tool.main([trace, "--frames", "1", "--top", "5"])


def test_intermediate_ap_equals_jax_tool(run_dir, tmp_path):
    """The same flax weights as a JAX run directory (orbax checkpoint)
    and, through the bridge, as the port's: the JAX tool and the port's
    give the same AP and the same boxes on the same fixture frames."""
    from hmvit_tpu.tools import inference as jinference
    from hmvit_tpu.train.checkpointing import \
        save_checkpoint as jsave_checkpoint
    from hmvit_tpu_torch.bridge import load_flax
    from hmvit_tpu_torch.data.opv2v import HeteroCooperativeDataset
    from hmvit_tpu_torch.models.zoo import build_model
    from hmvit_tpu_torch.tools.common import write_synthetic
    from hmvit_tpu_torch.train.checkpointing import save_checkpoint
    from hmvit_tpu_torch.train.trainer import create_train_state

    params = load_config("", model_dir=run_dir)
    write_synthetic(params, "ap_test_", 2048, num_scenarios=1, num_cavs=2,
                    num_frames=1)
    ds = HeteroCooperativeDataset(params, train=False, max_points=2048)
    _, _, v = _jax_variables(params, ds.collate_batch([ds[0]]))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for d in (jdir, pdir):
        d.mkdir()
        shutil.copy(os.path.join(run_dir, "config.yaml"), d / "config.yaml")
    jsave_checkpoint(str(jdir / "ckpt"), 1, {"params": v["params"],
                                             "batch_stats": v["batch_stats"]})
    model = load_flax(build_model(params["model"]), v)
    save_checkpoint(str(pdir / "ckpt"), 1, create_train_state(
        model, torch.optim.SGD(model.parameters(), lr=0.0)))
    argv = ["--synthetic", "--max_frames", "2", "--max_points", "2048",
            "--save_npy", "--ap_mode", "iou"]
    want = jinference.main(["--model_dir", str(jdir), *argv])
    got = inference.main(["--model_dir", str(pdir), "--cpu", *argv])
    assert got["iou"] == want["iou"]
    boxes = 0
    for i in range(2):
        name = os.path.join("npy", f"{i:04d}_pred.npy")
        mine, theirs = np.load(pdir / name), np.load(jdir / name)
        assert mine.shape == theirs.shape
        np.testing.assert_allclose(mine, theirs, atol=1e-3)
        np.testing.assert_array_equal(
            np.load(pdir / "npy" / f"{i:04d}_gt.npy"),
            np.load(jdir / "npy" / f"{i:04d}_gt.npy"))
        boxes += len(mine)
    assert boxes > 0  # the comparison saw boxes


def test_tools_load_no_yaml_opencv_pillow_or_jax(tmp_path):
    """The train and inference CLIs end to end in a fresh interpreter: no
    PyYAML, OpenCV, Pillow, JAX or JAX package module is ever loaded."""
    run = str(tmp_path / "run")
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from hmvit_tpu_torch.tools import inference, train\n"
        f"train.main(['--hypes_yaml', {SMOKE!r}, '--model_dir', {run!r},\n"
        "            '--synthetic', '--epoches', '1', '--steps_per_epoch',\n"
        "            '1', '--max_points', '1024', '--cpu'])\n"
        f"inference.main(['--model_dir', {run!r}, '--synthetic',\n"
        "                '--max_frames', '1', '--max_points', '1024',\n"
        "                '--cpu'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('yaml', 'cv2', 'PIL', 'jax', 'flax', 'hmvit_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("ok"), \
        res.stderr[-2000:]


def test_flops_are_the_counter_plus_the_kernel_counts():
    """``performance.count_flops`` = ``FlopCounterMode``'s count with the
    plain twins hidden + the kernel formulas; each serving wrapper
    recorded once a call (the tiny flagship at batch 1 on the split
    route: pair warp x4, stripe x2, plain x2 for the fusion's grid
    phases; the camera self-attention reaches the plain wrapper only on
    CUDA tensors, and on the CPU the counter counts its einsums instead);
    the twins' own FLOPs are not in the counter's count."""
    from torch.utils.flop_counter import FlopCounterMode

    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.ops.opcount import record_kernel_ops
    from hmvit_tpu_torch.serving import request_batch
    from tiny_cfg import RANGE
    from torch_parity import t, tiny_flagship_cfg

    model = init_parameters(HMViT(tiny_flagship_cfg()), seed=0)
    model.requires_grad_(False)  # the counter's module tracker hooks autograd
    one = {k: t(x) for k, x in request_batch(
        0, max_points=512, image_size=64, num_cams=2,
        lidar_range=RANGE).items()}
    total = performance.count_flops(model, one)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter, record_kernel_ops() as calls:
        model(one)
    kernel_ops = sum(ops for _, ops in calls)
    assert kernel_ops > 0
    assert total == float(counter.get_total_flops()) + kernel_ops
    names = [name for name, _ in calls]
    assert {n: names.count(n) for n in set(names)} == {
        "pair_warp": 4, "stripe_window_attention": 2,
        "plain_window_attention": 2}
    unhidden = FlopCounterMode(display=False)
    with torch.no_grad(), unhidden:
        model(one)
    assert unhidden.get_total_flops() > counter.get_total_flops()


def test_kernel_operation_formulas():
    """The formulas chip_smoke.py's bounds and the FLOP count share: at
    the production shapes (128^2 maps, window 8, 8 heads of 32, 4
    agents) a multiply-add is 2 operations."""
    from hmvit_tpu_torch.ops.opcount import attention_ops, pair_warp_ops

    t, d, heads, windows = 64, 32, 8, 256
    qk_pv = 2 * (2 * t * t * d)  # q k^T and p v per sender window
    assert attention_ops(4, windows, t, 4, heads, d) == \
        4 * windows * heads * 4 * qk_pv
    typed = 2 * (2 * t * d * d)  # q W_att and v W_msg per sender window
    assert attention_ops(4, windows, t, 4, heads, d, typed=True) == \
        4 * windows * heads * 4 * (qk_pv + typed)
    assert pair_warp_ops(3, 4, 128, 128, 512) == 12.0 * 3 * 4 * 128 ** 2 * 512


def test_flop_counter_counts_bmm_with_out_dtype():
    """``bmm(a, b, out_dtype=float32)`` (the bf16 [K|V] contraction's
    product on the card) counts as a ``bmm``; the library's own formula
    takes the dtype for the output's shape and raises."""
    from hmvit_tpu_torch.ops.opcount import flop_counter

    a = torch.empty(3, 40, 32, device="meta", dtype=torch.bfloat16)
    b = torch.empty(3, 32, 24, device="meta", dtype=torch.bfloat16)
    counter = flop_counter()
    with counter:
        out = torch.bmm(a, b, out_dtype=torch.float32)
        torch.bmm(a, b)
    assert out.dtype == torch.float32
    assert counter.get_total_flops() == 2 * (2 * 3 * 40 * 32 * 24)
