"""The port's tracer on the card: a span and the kernel launched inside
it line up on an exported profiler trace through the anchor; a bucket
captured with the tracer on gives the untraced bucket's outputs bit for
bit, and its stage times sum to a CUDA-event timing of the whole replay
within 5%; a span that reads a value back counts one sync and a span
that only launches counts none.  These need an NVIDIA GPU and skip
elsewhere; the card's machine has no JAX, so run them there without the
suite's conftest:
``python -m pytest tests/test_torch_cuda_tracing.py -q -m gpu -s --noconftest``."""
import json

import pytest
import torch

from hmvit_tpu_torch import tracing

pytestmark = pytest.mark.gpu

STAGES = ["camera", "lidar", "fusion", "decoder", "decode_nms"]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events and graphs run only "
                    "on the card)")
    return torch.device("cuda", 0)


def test_a_span_lines_up_with_its_launch_on_the_trace(dev, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # device activity only, as a training step's trace is taken
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with tracing.on() as tracer:
            tracing.anchor()
            torch.cuda.synchronize()
            with tracing.span("probe"):
                torch.cuda._sleep(200_000)
            torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    record = tracer.collect()
    anchor, = record["anchors"]
    offset = tracing.trace_offset_us(trace, anchor)
    probe, = record["spans"]
    lo, hi = probe["start_us"] + offset, probe["end_us"] + offset
    events = [ev for ev in trace["traceEvents"] if ev.get("ph") == "X"]
    spin, = [ev for ev in events if ev.get("cat") == "kernel"
             and "spin_kernel" in ev["name"]]
    launch, = [ev for ev in events
               if ev.get("cat") in tracing.RUNTIME_CATEGORIES
               and ev.get("args", {}).get("correlation")
               == spin["args"]["correlation"]]
    start = float(launch["ts"])
    end = start + float(launch["dur"])
    widths = [round(t1 - t0, 1) for t0, t1 in anchor]
    print(f"anchor intervals {widths} us; span [{lo:.1f}, {hi:.1f}], "
          f"launch [{start:.1f}, {end:.1f}], kernel at "
          f"{float(spin['ts']):.1f} on {torch.cuda.get_device_name()}")
    assert lo - 50.0 <= start and end <= hi + 50.0
    assert lo <= float(spin["ts"])


def test_traced_bucket_stage_times_sum_to_the_replay(dev):
    from hmvit_tpu_torch.data.anchors import generate_anchor_grid
    from hmvit_tpu_torch.graph_server import CompiledServer, _bucket_key
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.serving import (
        PROD_CFG,
        anchor_args,
        batch_to_device,
        request_batch,
        serving_config,
        serving_hints,
    )

    batch = request_batch(0)
    hints = serving_hints(batch["mode"][0], 4)
    request = batch_to_device(batch, dev, bf16=True)
    model = init_parameters(HMViT(serving_config(PROD_CFG, bf16=True)),
                            seed=0).to(dev, torch.bfloat16).eval()
    anchors = torch.as_tensor(generate_anchor_grid(anchor_args(PROD_CFG),
                                                   "hwl"),
                              dtype=torch.float32, device=dev)
    server = CompiledServer(model, hints, request, anchors,
                            torch.eye(4, device=dev))
    plain = server.buckets[_bucket_key(request, hints)]
    assert plain.forward_marks == [] and plain.detect_marks == []
    out, det = server(request)
    expected = [out["psm"].clone(), out["rm"].clone(),
                *(t.clone() for t in det[0])]
    with tracing.on():
        traced = server.bucket(request, hints)  # the traced twin
    assert len(server.buckets) == 2
    # the camera bucket runs the camera encoder first
    assert [m[0] for m in traced.forward_marks] == ["camera", "lidar",
                                                    "fusion", "decoder"]
    assert [m[0] for m in traced.detect_marks] == ["decode_nms"]
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with tracing.on() as tracer:
        for _ in range(3):
            server.load(request)
            torch.cuda.synchronize()
            start.record()
            server.replay_forward(traced)
            tracing.replay(traced.detect_graph, traced.detect_marks)
            end.record()
            torch.cuda.synchronize()
        whole = start.elapsed_time(end)
    got = [traced.out["psm"], traced.out["rm"], *traced.det[0]]
    assert all(torch.equal(a, b) for a, b in zip(expected, got))
    stages = tracer.collect()["stages"][-5:]
    assert sorted(s["name"] for s in stages) == sorted(STAGES)
    assert all(s["graph"] for s in stages)
    total = sum(s["ms"] for s in stages)
    split = {s["name"]: round(s["ms"], 4) for s in stages}
    print(f"traced replay: stages {split} sum {total:.4f} ms, whole "
          f"replay {whole:.4f} ms on {torch.cuda.get_device_name()}")
    assert abs(total - whole) <= 0.05 * whole


def test_syncs_are_counted_by_span(dev):
    x = torch.ones(1024, device=dev)
    mode = torch.cuda.get_sync_debug_mode()
    with tracing.on() as tracer:
        assert torch.cuda.get_sync_debug_mode() == 1
        with tracing.span("read"):
            x.sum().item()
        with tracing.span("launch"):
            for _ in range(4):
                x = x * 2 + 1
        torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == mode
    assert [s["syncs"] for s in tracer.collect()["spans"]] == [1, 0]
