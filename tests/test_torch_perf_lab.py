"""The port's stage-timing entry point, ``hmvit_tpu_torch.perf_lab``:
its CPU rehearsal drives every stage (fusion, segmented scan, expansion,
lidar, and the program's tracer over served frames and train steps, on
a model of the production structure at test widths) through the
kernels' plain twins at a tiny size (the stages' own bit-for-bit
assertions hold there too), it refuses to run without a CUDA device
unless ``--cpu`` is given, and an unknown stage raises.  No time printed
here is a device time, and each line says so."""
import pytest
import torch

from hmvit_tpu_torch import perf_lab


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.mark.parametrize("stage,lines", [
    ("attn", 2), ("pairwarp", 2), ("pairwarp_res", 6), ("fused_wa", 3),
    ("segscan", 2), ("expand", 4), ("lidar", 4), ("tracer", 8)])
def test_cpu_rehearsal_runs_stage(stage, lines, capsys):
    assert perf_lab.main(["--cpu", "--iters", "1", stage]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == lines
    assert all(line.endswith("[cpu rehearsal, plain twins, not a device "
                             "time]") and " ms" in line for line in out)


def test_refuses_to_run_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the stages would run")
    assert perf_lab.main(["attn"]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


def test_unknown_stage_raises():
    with pytest.raises(ValueError):
        perf_lab.run_stages(["warp9"], "cpu", iters=1,
                            shapes=perf_lab.TINY)


def test_stages_cover_the_production_shapes():
    """B = 1, 128^2 x 256 maps, 8 heads of 32, window 8."""
    s = perf_lab.PROD
    assert (s.hw, s.heads, s.dim_head, s.win, s.c) == (128, 8, 32, 8, 256)
    assert (s.grid, s.points, s.pfn, s.clouds, s.expand_rows) == (
        512, 30000, 64, 2, 40000)
    assert s.voxel_size == pytest.approx((0.4, 0.4, 4.0))
    assert sorted(perf_lab.STAGES) == ["attn", "expand", "fused_wa", "lidar",
                                       "pairwarp", "pairwarp_res", "segscan",
                                       "tracer"]


def test_profile_helpers():
    """The union of device intervals counts an overlap once; the
    rehearsal model keeps the production structure; the lab's request is
    the smoke run's."""
    import chip_smoke
    from hmvit_tpu_torch.serving import PROD_CFG, anchor_args, request_batch

    assert perf_lab._busy_us([(0, 10), (5, 12), (20, 21), (20.5, 20.6)]) == 13
    assert perf_lab._busy_us([]) == 0
    tiny = perf_lab.rehearsal_cfg()
    assert set(tiny) == set(PROD_CFG)
    assert tiny["hetero_fusion"]["num_iters"] == 2
    assert tiny["camera"]["backbone"] == PROD_CFG["camera"]["backbone"]
    assert PROD_CFG["lidar"]["point_pillar_scatter"]["grid_size"][0] == 512
    args = anchor_args(PROD_CFG)
    assert (args["W"], args["H"], args["vw"], args["feature_stride"]) == (
        512, 512, 0.4, 4)
    a, b = chip_smoke.prod_batch(1), request_batch(1)
    assert sorted(a) == sorted(b)
    assert all((a[k] == b[k]).all() for k in a)


def span(name, start, end, unit, parent=None, syncs=0):
    return {"name": name, "start_us": float(start), "end_us": float(end),
            "unit": unit, "parent": parent, "syncs": syncs}


def test_idle_by_outermost_phase():
    """Idle device time falls to the outermost phase span open over it,
    on the trace's clock (the spans' + the anchor's offset), from the
    first read step on."""
    # host clock + 1000 = trace clock; one step: request [0, 10), forward
    # [10, 40) with a stage span inside, backward [40, 70) with a twin's
    # range inside, optimizer [70, 90); device busy [5, 12), [20, 45),
    # [60, 95): idle [0, 5) request, [12, 20) forward, [45, 60) backward
    spans = [span("request", -900, -890, 0, syncs=7),  # a step not read
             span("request", 0, 10, 1), span("train.forward", 10, 40, 1),
             span("camera", 12, 30, 1, parent=2),
             span("train.backward", 40, 70, 1),
             span("twin_backward:pair_warp", 45, 60, 1, parent=4),
             span("train.optimizer", 70, 90, 1, syncs=2)]
    device = [(1020.0, 1045.0), (1005.0, 1012.0), (1060.0, 1095.0)]
    assert perf_lab.idle_by_phase(spans, 1000.0, device, 1) == {
        "request": 5.0, "train.forward": 8.0, "train.backward": 15.0,
        "train.optimizer": 0.0, "all": 28.0}
    # a phase span nested in another is not the outermost: not charged
    nested = spans + [span("request", 14, 16, 1, parent=2)]
    assert perf_lab.idle_by_phase(nested, 1000.0, device, 1)["request"] \
        == 5.0
    # the unread step's idle counts once it is read
    assert perf_lab.idle_by_phase(spans, 1000.0, device, 0)["all"] > 28.0
    assert perf_lab.idle_by_phase(spans, 1000.0, [], 1)["all"] == 0.0


def test_span_table_sums_time_self_time_and_syncs():
    spans = [span("request", 0, 100, 0, syncs=5),  # a frame not read
             span("request", 1000, 1300, 1, syncs=12),
             span("train.forward", 1300, 2300, 1, syncs=1),
             span("camera", 1400, 1900, 1, parent=2),
             span("request", 3000, 3500, 2, syncs=12)]
    table = perf_lab.span_table(spans, first_unit=1)
    assert table["request"] == pytest.approx([0.8, 0.8, 24])
    assert table["train.forward"] == pytest.approx([1.0, 0.5, 1])
    assert table["camera"] == pytest.approx([0.5, 0.5, 0])
    assert perf_lab.span_table(spans)["request"][2] == 29


def test_dense_clouds_fill_runs_up_to_the_cap():
    """The scan stage's dense case at the production size: every point
    in range, most rows kept, and runs that reach the cap of 32 rows -
    the look-back the scene clouds' one-point pillars never ask for."""
    from hmvit_tpu_torch.ops.voxelize import pillarize

    s = perf_lab.PROD
    gen = torch.Generator().manual_seed(0)
    pts, mask = perf_lab.dense_clouds(gen, "cpu", s.clouds, s.points,
                                      s.voxel_size, perf_lab.LIDAR_RANGE)
    assert pts.shape == (s.clouds, s.points, 4) and bool(mask.all())
    info = pillarize(pts, mask, s.voxel_size, perf_lab.LIDAR_RANGE,
                     (s.grid, s.grid), 32)
    num_cells = s.clouds * s.grid * s.grid
    assert int(info["pillar_id"].max()) < num_cells  # none out of range
    kept = info["pillar_id"][info["keep"]]
    assert len(kept) > 0.9 * s.clouds * s.points
    runs = torch.unique_consecutive(kept, return_counts=True)[1]
    assert int(runs.max()) == 32 and float(runs.float().mean()) > 16
