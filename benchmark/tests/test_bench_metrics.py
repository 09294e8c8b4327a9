"""The metric arithmetic: the tail over every frame, rates over the whole
window, idle share from device intervals, roofline shares from bounds,
and the frozen bound formulas against the port's operation counts."""
import numpy as np
import pytest

from benchmark import peaks, serve, trace as tr
from benchmark.metrics import device_idle_share, mfu, roofline, stage_ms
from benchmark.rooflines import attention


def ev(name, ts, dur, cat="kernel", corr=None):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "args": {} if corr is None else {"correlation": corr}}


def test_tail_is_over_every_frame():
    lat = list(np.linspace(0.01, 0.02, 101)) + [1.0] * 6
    # 6 of 107 frames are slow: the 95th percentile sees them
    assert serve.percentile(lat, 95) == pytest.approx(
        np.percentile(lat, 95))
    assert serve.percentile(lat, 95) > 0.5


def test_busy_union_and_idle_share():
    t = tr.Trace({"traceEvents": [ev("a", 0, 10), ev("b", 5, 10),
                                  ev("c", 30, 10), ev("d", 100, 5)]})
    # [0, 15) and [30, 40) inside [0, 50): 25 us busy
    assert tr.busy_us(t.device_in(0, 50), 0, 50) == 25
    share = device_idle_share.read({"window_s": 50e-6,
                                    "busy_s": 25e-6}, "serve")
    assert share == pytest.approx(50.0)
    gaps = tr.idle_gaps(t, 0, 50)
    assert [round(g[1] * 1e6) for g in gaps] == [15, 10]


def test_idle_gap_names_the_host_operation():
    t = tr.Trace({"traceEvents": [
        ev("k", 0, 10), ev("k", 50, 10),
        ev("aten::copy_", 12, 30, cat="cpu_op"),
        ev("outer", 0, 100, cat="user_annotation")]})
    (label, seconds), = tr.idle_gaps(t, 0, 60)
    assert label == "aten::copy_" and seconds == pytest.approx(40e-6)


def test_ranges_attribute_device_work_by_launch():
    t = tr.Trace({"traceEvents": [
        dict(ev("stage: fusion", 0, 100, cat="user_annotation"),
             pid=1, tid=1),
        dict(ev("cudaLaunchKernel", 10, 2, cat="cuda_runtime", corr=7),
             pid=1, tid=1),
        dict(ev("cudaLaunchKernel", 200, 2, cat="cuda_runtime", corr=8),
             pid=1, tid=1),
        ev("gemm", 150, 40, corr=7), ev("gemm", 210, 40, corr=8)]})
    inside = t.launched_inside("stage: ")
    assert [e["ts"] for e in inside["stage: fusion"]] == [150]
    assert stage_ms.read({"stage_ranges": inside, "stage_frames": 2},
                         "fusion") == pytest.approx(0.02)


def test_rate_metrics():
    assert mfu.read({"flops": 1e12, "rate": 20.0}, "serve") == \
        pytest.approx(100 * 20e12 / peaks.MFU_PEAK_FLOPS)
    assert mfu.read({"flops": None, "rate": 20.0}, "serve") is None


def test_attention_bound_matches_the_port_operation_count():
    from hmvit_tpu_torch.ops.opcount import attention_ops

    # K2 at the fusion's local phase: 4 maps, 256 windows of 64, 4
    # senders, 8 heads of 32, bf16
    ints = [1, 4, 4, 256, 64, 8, 16, 8, 32]
    ops = attention_ops(4, 256, 64, 4, 8, 32)
    c, tokens = 256, 256 * 64
    nbytes = 2 * (2 * 4 * tokens * c + 4 * 4 * tokens * 2 * c) + \
        4 * (8 * 64 * 64 + 4 * 4 * tokens)
    assert attention.launch_bound_s(ints) == pytest.approx(
        max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.OPS_PER_S["bfloat16"]))


def test_roofline_share_from_bounds(monkeypatch):
    from benchmark.rooflines import K2

    monkeypatch.setattr(K2, "bound_s", lambda launch, request, config: 1e-6)
    frame = ev("bench_frame", 0, 1000, cat="user_annotation")
    name = ("void window_attention_mma_kernel<32, 64, 2, false, 1u>"
            "(float const*)")
    t = tr.Trace({"traceEvents": [frame, ev(name, 10, 4), ev(name, 20, 4)]})
    ctx = {"trace": t, "traced_frames": [(0, frame)], "pool": [{}], "config": {},
           "launches": {"stripe_window_attention": [{}, {}]}}
    assert roofline.read(ctx, "K2") == pytest.approx(100 * 2e-6 / 8e-6)
    ctx["launches"]["stripe_window_attention"] = [{}]
    with pytest.raises(RuntimeError):
        roofline.read(ctx, "K2")
    assert roofline.read(dict(ctx, launches={}), "K2") is None


def test_pair_warp_touched_bytes_against_the_whole_map():
    import torch

    from benchmark.rooflines import K1

    eye = torch.eye(4).repeat(1, 2, 2, 1, 1)
    far = eye.clone()
    far[0, 1, 0, 0, 3] = far[0, 0, 1, 0, 3] = 300.0  # out of view
    near = K1.touched_pixels(eye, [1, 0], 2, 2, 64, 0.4, 4)
    out = K1.touched_pixels(far, [1, 0], 2, 2, 64, 0.4, 4)
    # the two receivers read different typed maps: identity poses read
    # every pixel of both senders' maps in both types; a sender 300 m
    # away is read by nobody, so each receiver reads its own map only
    assert near == 4 * 64 * 64
    assert out == 2 * 64 * 64
