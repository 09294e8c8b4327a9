"""hmvit_tpu_torch/tools/profile.py: the chrome-trace rollup by kernel
class on a small synthetic trace (the cases of tests/test_profile_tool.py
on the port's trace format): the classes, the per-name totals that
ignore host events, the ``--frames`` division and the ``--top`` order;
and the rollup of the device operations launched inside named profiler
ranges (``--ranges``), by the launch's correlation id."""
import gzip
import json

import pytest

from hmvit_tpu_torch.tools.profile import (
    device_op_totals,
    hand_written_kernel,
    main,
    op_class,
    range_totals,
    summarize,
)

CONV = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<c10::BFloat16>>(int)")
CAT = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<float>()"
STRIPE = ("void hm::window_attention_mma_kernel<32, 64, 2, false, 1>"
          "(const __nv_bfloat16*)")
WARP = "void hm::pair_warp_kernel<__nv_bfloat16>(const __nv_bfloat16*)"


def make_trace():
    def ev(name, dur, cat="kernel", ph="X"):
        return {"ph": ph, "cat": cat, "name": name, "dur": dur, "ts": 0,
                "pid": 0, "tid": 7}

    return {"traceEvents": [
        ev(CONV, 5000.0), ev(CONV, 3000.0), ev(GEMM, 1500.0),
        ev(ADD, 250.0), ev(ADD, 250.0), ev(CAT, 100.0),
        ev(STRIPE, 400.0), ev(WARP, 800.0),
        ev("Memcpy HtoD (Pageable -> Device)", 60.0, "gpu_memcpy"),
        ev("Memset (Device)", 40.0, "gpu_memset"),
        # host events that must be ignored
        ev("aten::conv2d", 9000.0, "cpu_op"),
        ev("cudaGraphLaunch", 20.0, "cuda_runtime"),
        ev(CONV, 7.0, ph="i"),
    ]}


def test_op_class():
    assert op_class(CONV) == "convolution"
    assert op_class(GEMM) == "GEMM"
    assert op_class(ADD) == "elementwise"
    assert op_class(CAT) == "copy / permute"
    assert op_class("void at::native::reduce_kernel<512, 1>()") == \
        "reduction"
    assert op_class("void at::native::vectorized_layer_norm_kernel<>()") \
        == "reduction"
    assert op_class(STRIPE) == "hand-written: stripe_window_attention"
    assert op_class(WARP) == "hand-written: pair_warp"
    assert op_class("Memcpy DtoD", "gpu_memcpy") == "memcpy / memset"
    assert op_class("some_kernel_of_its_own") == "other"


@pytest.mark.parametrize("name,kernel", [
    ("void hm::window_attention_mma_kernel<32, 64, 2, false, 0>()",
     "plain_window_attention"),
    ("void hm::window_attention_mma_kernel<32, 64, 1, true, 0>()",
     "typed_window_attention"),
    ("void hm::window_attention_mma_kernel<32, 16, 1, false, 2>()",
     "warp_window_attention"),
    ("void hm::window_attention_kernel<float, true>()",
     "stripe_window_attention"),
    ("void hm::window_attention_kernel<float, false>()",
     "plain_window_attention"),
    ("void hm::warp_window_attention_kernel<float>()",
     "warp_window_attention"),
    ("void hm::typed_window_attention_kernel<float>()",
     "typed_window_attention"),
    ("void hm::pair_warp_resident_kernel<__nv_bfloat16>()",
     "pair_warp_resident"),
    ("void hm::pair_warp_previous_kernel<float>()", "pair_warp_previous"),
    ("void hm::segmented_max_scan_kernel<__nv_bfloat16>()",
     "segmented_max_scan"),
    ("void hm::segmented_max_scan_carry_kernel<float>()",
     "segmented_max_scan"),
    ("void hm::expand_slice_kernel<false, uint4>()", "expand_rows"),
    ("void hm::expand_slice_kernel<true, uint4>()", "expand_rows_v2"),
    ("void (anonymous namespace)::ms_deform_attn_kernel<float>()",
     "ms_deform_attn"),
    (CONV, None), (ADD, None)])
def test_hand_written_kernel_names(name, kernel):
    assert hand_written_kernel(name) == kernel


def test_device_op_totals_ignore_host_events():
    agg, cnt, cat = device_op_totals(make_trace())
    assert agg[CONV] == 8000.0 and cnt[CONV] == 2
    assert agg[ADD] == 500.0 and cnt[ADD] == 2
    assert "aten::conv2d" not in agg and "cudaGraphLaunch" not in agg
    assert cat["Memset (Device)"] == "gpu_memset"
    assert sum(cnt.values()) == 10


@pytest.mark.parametrize("packed", [False, True])
def test_summarize_divides_by_frames_and_orders_top(tmp_path, capsys,
                                                    packed):
    d = tmp_path / "trace"
    d.mkdir()
    data = json.dumps(make_trace())
    if packed:
        with gzip.open(d / "bench_trace.json.gz", "wt") as f:
            f.write(data)
    else:
        (d / "bench_trace.json").write_text(data)
    res = summarize(str(d), top=3, frames=2)
    total_us = 5000 + 3000 + 1500 + 500 + 100 + 400 + 800 + 60 + 40
    assert res["total_ms"] == pytest.approx(total_us / 1e3 / 2)
    assert res["by_class"]["convolution"] == pytest.approx(8.0 / 2)
    assert res["by_class"]["hand-written: pair_warp"] == pytest.approx(0.4)
    assert res["by_class"]["memcpy / memset"] == pytest.approx(0.05)
    assert [name for name, _, _ in res["top"]] == [CONV, GEMM, WARP]
    assert res["top"][0][2] == 1  # 2 launches over 2 frames
    out = capsys.readouterr().out
    assert "ms/frame (2 frame(s)" in out and "-- top 3" in out


def test_cli(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(make_trace()))
    main([str(path), "--top", "2", "--frames", "1"])
    out = capsys.readouterr().out
    assert out.startswith("total device time: 11.400 ms/frame")
    assert "convolution" in out and "-- top 2" in out
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit, match="no chrome trace"):
        main([str(tmp_path / "empty")])


def make_range_trace():
    """Two twin-backward ranges on the autograd thread (tid 9) and one
    other range; each launch (cuda_runtime, correlation id) maps to a
    device event of the same id."""
    def x(name, cat, ts, dur, tid=9, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
              "pid": 1, "tid": tid}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    return {"traceEvents": [
        x("twin_backward:pair_warp", "user_annotation", 100, 50),
        x("twin_backward:plain_window_attention", "user_annotation", 200, 50),
        x("forward", "user_annotation", 300, 50),
        x("cudaLaunchKernel", "cuda_runtime", 110, 2, corr=1),
        x("cudaLaunchKernel", "cuda_runtime", 120, 2, corr=2),
        x("cudaLaunchKernel", "cuda_runtime", 210, 2, corr=3),
        x("cudaLaunchKernel", "cuda_runtime", 310, 2, corr=4),
        # a launch at the same time on another thread: not in a range
        x("cudaLaunchKernel", "cuda_runtime", 115, 2, tid=3, corr=5),
        x(ADD, "kernel", 400, 30, tid=7, corr=1),
        x(CAT, "kernel", 440, 20, tid=7, corr=2),
        x(GEMM, "kernel", 470, 40, tid=7, corr=3),
        x(CONV, "kernel", 520, 60, tid=7, corr=4),
        x(ADD, "kernel", 600, 10, tid=7, corr=5),
    ]}


def test_range_totals_by_correlation():
    got = range_totals(make_range_trace(), "twin_backward:")
    assert got == {
        "twin_backward:pair_warp": {"elementwise": 30.0,
                                    "copy / permute": 20.0},
        "twin_backward:plain_window_attention": {"GEMM": 40.0}}
    assert range_totals(make_range_trace(), "nothing:") == {}


def test_cli_ranges(tmp_path, capsys):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(make_range_trace()))
    res = summarize(str(path), top=1, frames=1, ranges="twin_backward:")
    assert res["ranges"]["twin_backward:pair_warp"]["elementwise"] == \
        pytest.approx(0.03)
    main([str(path), "--ranges", "twin_backward:"])
    out = capsys.readouterr().out
    assert "-- inside ranges twin_backward:* (ms/frame): 0.090" in out
