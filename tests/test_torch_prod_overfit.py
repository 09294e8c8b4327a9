"""The port's accuracy gate (``hmvit_tpu_torch/prod_overfit.py``) on the
CPU: the script itself at a shrunk ``--grid`` (the same fixture ->
loader -> labels -> remat train step -> eval forward -> decode -> NMS ->
VOC AP path as on the card), asserting what ``tests/test_prod_overfit.py``
asserts of the JAX script; and the oracle decode (each frame's labels as
its outputs) scoring AP 1.0 at every threshold, equal to the JAX
package's ``post_process`` + evaluation of the same outputs."""
import json

import numpy as np
import pytest
import torch

from hmvit_tpu.postprocess import AnchorPostprocessor as JPostprocessor
from hmvit_tpu.utils import evaluation as jeval
from hmvit_tpu_torch import prod_overfit
from hmvit_tpu_torch.postprocess import AnchorPostprocessor

SHRUNK = ["--grid", "64", "--image_size", "64", "--num_cavs", "2",
          "--max_points", "4096"]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def test_port_gate_machinery_shrunk(tmp_path):
    log = tmp_path / "po.jsonl"
    summary = prod_overfit.main(SHRUNK + [
        "--max_steps", "4", "--eval_every", "2", "--target", "2.0",
        "--fp32", "--cpu", "--log", str(log)])
    assert summary["max_steps"] == 4
    assert summary["wall_s"] > 0 and summary["compile_s"] > 0
    for k in ("ap30", "ap50", "ap70"):
        assert 0.0 <= summary[k] <= 1.0
    assert summary["device"] == "cpu" and summary["load_ms_per_frame"] > 0
    records = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(records) == 2  # evals at steps 2 and 4
    assert all(np.isfinite(r["loss"]) for r in records)


def test_oracle_decode_scores_one_in_both_packages():
    """The labels of the port's loader as outputs: AP 1.0 at 0.3, 0.5 and
    0.7 through the port's decode and evaluation, and the same through
    the JAX package's on the same numpy outputs."""
    args = prod_overfit.parse_args(SHRUNK + ["--cpu"])
    cfg, lidar_range = prod_overfit.gate_config(args.grid)
    pp_cfg = prod_overfit.postprocess_config(args.grid, lidar_range)
    pp = AnchorPostprocessor(pp_cfg, train=False)
    anchors = pp.generate_anchor_box()
    _, labels, gt, _ = prod_overfit.load_gate_data(
        args, lidar_range, pp, anchors, torch.device("cpu"))
    outs = [prod_overfit.oracle_outputs(lab) for lab in labels]
    assert all(int(lab["pos_equal_one"].sum()) >= len(g)
               for lab, g in zip(labels, gt))
    assert prod_overfit.average_precision(outs, gt, pp, anchors) == \
        (1.0, 1.0, 1.0)
    jpp = JPostprocessor(pp_cfg, train=False)
    stat = jeval.new_result_stat("iou")
    for out, g in zip(outs, gt):
        corners, scores = jpp.post_process(
            {0: {"transformation_matrix": np.eye(4), "anchor_box": anchors,
                 "no_post_projection": True}},
            {0: {"psm": out["psm"].numpy(), "rm": out["rm"].numpy()}})
        jeval.accumulate_frame(corners, scores, g, stat)
    assert jeval.final_results(stat)["iou"] == {
        "ap_30": 1.0, "ap_50": 1.0, "ap_70": 1.0}


def test_bf16_bar_reads_bf16_server_against_fp32_forward():
    """``tools/bf16_bar.py``'s reading on the CPU (random weights of the
    shrunk gate configuration, one fixture frame): one row a frame, the
    bf16 server within bf16's reach of the fp32 forward and not equal to
    it."""
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.tools.bf16_bar import BAR, bar_readings

    args = prod_overfit.parse_args(SHRUNK + ["--cpu"])
    cfg, lidar_range = prod_overfit.gate_config(args.grid)
    pp = AnchorPostprocessor(prod_overfit.postprocess_config(
        args.grid, lidar_range))
    batches, _, _, _ = prod_overfit.load_gate_data(
        args, lidar_range, pp, pp.generate_anchor_box(), torch.device("cpu"))
    weights = init_parameters(HMViT(cfg), seed=0).state_dict()
    rows = bar_readings(weights, cfg, batches[:1], torch.device("cpu"))
    assert len(rows) == 1 and rows[0]["bar"] == BAR
    assert 0.0 < rows[0]["max_abs_sigmoid_psm"] < 0.05
    assert rows[0]["max_abs_rm_over_scale"] < 0.1


@pytest.mark.parametrize("stage", ["lidar", "camera", "fusion", "decoder"])
def test_bf16_bar_keeps_one_stage_in_fp32(stage):
    """``--fp32_stage``: the reading with one stage of the bf16 server in
    float32 (its compute dtype in the configuration, its weights cast
    back), on the CPU at the shrunk shapes."""
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.serving import serving_config
    from hmvit_tpu_torch.tools.bf16_bar import bar_readings, \
        stage_fp32_config

    args = prod_overfit.parse_args(SHRUNK + ["--cpu"])
    cfg, lidar_range = prod_overfit.gate_config(args.grid)
    served = serving_config(dict(cfg, remat=False), bf16=True)
    kept = stage_fp32_config(served, stage)
    def dtypes(c):
        return {"lidar": c["lidar"].get("compute_dtype"),
                "camera": c["camera"].get("compute_dtype"),
                "fusion": c["hetero_fusion"]["hetero_fusion_block"][
                    "compute_dtype"],
                "decoder": c["hetero_decoder"].get("compute_dtype")}

    want = dict(dtypes(served), **{
        stage: {"lidar": None, "camera": "float32", "fusion": "float32",
                "decoder": None}[stage]})
    assert dtypes(kept) == want and dtypes(served)["fusion"] == "bfloat16"
    pp = AnchorPostprocessor(prod_overfit.postprocess_config(
        args.grid, lidar_range))
    batches, _, _, _ = prod_overfit.load_gate_data(
        args, lidar_range, pp, pp.generate_anchor_box(), torch.device("cpu"))
    weights = init_parameters(HMViT(cfg), seed=0).state_dict()
    rows = bar_readings(weights, cfg, batches[:1], torch.device("cpu"),
                        fp32_stage=stage)
    assert len(rows) == 1 and rows[0]["fp32_stage"] == stage
    assert 0.0 <= rows[0]["max_abs_sigmoid_psm"] < 0.05
