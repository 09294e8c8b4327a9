"""The port's tracer (``hmvit_tpu_torch/tracing.py``) on the CPU: off it
records nothing and leaves the graph server's bucket key as it was; on,
spans carry their parent and their frame or step id and self time is a
span less its children; the rehearsal forward gives the same bits on and
off and records its stages; a train step records its phases, the
kernels' backward ranges inside ``train.backward``; stage marks recorded
into a capture are read back a replay; the anchor's offset arithmetic;
syncs counted against the innermost span.  The card's half is
``test_torch_cuda_tracing.py``."""
import warnings

import pytest
import torch

from hmvit_tpu_torch import tracing
from hmvit_tpu_torch.graph_server import HINT_KEYS, _bucket_key


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def names(record, keep=None):
    return [s["name"] for s in record["spans"]
            if keep is None or s["name"] in keep]


def test_off_records_nothing_and_keeps_the_bucket_key():
    assert not tracing.active()
    # one shared null context, whatever the name
    assert tracing.span("a") is tracing.span("b", new_unit=True) \
        is tracing.mark("c", torch.zeros(1))
    with tracing.span("a"), tracing.mark("c", torch.zeros(1)):
        pass
    request = {"points": torch.zeros(2, 3),
               "mode": torch.zeros(1, 5, dtype=torch.int32)}
    hints = {"camera_bucket": 2, "active_agents": 4, "static_modes": (1, 0)}
    parent_key = tuple(hints.get(k) for k in HINT_KEYS) + (
        ("mode", (1, 5), torch.int32), ("points", (2, 3), torch.float32))
    assert _bucket_key(request, hints) == parent_key
    with tracing.on() as tracer:
        assert _bucket_key(request, hints) == parent_key + ("traced",)
    assert _bucket_key(request, hints) == parent_key
    assert tracer.collect()["spans"] == []


def test_parents_units_and_self_time():
    with tracing.on() as tracer:
        with tracing.span("warm-up"):
            pass
        for _ in range(2):
            with tracing.span("request", new_unit=True):
                with tracing.span("copy"):
                    pass
            with tracing.span("forward"):
                with tracing.span("camera"):
                    with tracing.span("inner"):
                        pass
                with tracing.span("fusion"):
                    pass
    spans = tracer.collect()["spans"]
    assert [s["name"] for s in spans] == [
        "warm-up", "request", "copy", "forward", "camera", "inner",
        "fusion", "request", "copy", "forward", "camera", "inner", "fusion"]
    assert [s["unit"] for s in spans] == [0] + [1] * 6 + [2] * 6
    assert [s["parent"] for s in spans] == [
        None, None, 1, None, 3, 4, 3, None, 7, None, 9, 10, 9]
    assert all(s["end_us"] >= s["start_us"] for s in spans)
    # self time on made-up intervals: children overlapping each other
    # and reaching past their parent count once, inside the parent
    made = [{"parent": None, "start_us": 0.0, "end_us": 100.0},
            {"parent": 0, "start_us": 10.0, "end_us": 40.0},
            {"parent": 0, "start_us": 30.0, "end_us": 50.0},
            {"parent": 0, "start_us": 90.0, "end_us": 120.0},
            {"parent": 1, "start_us": 20.0, "end_us": 25.0}]
    assert tracing.self_us(made) == [100 - 40 - 10, 25, 20, 30, 5]


def test_forward_is_unchanged_and_records_its_stages():
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.perf_lab import rehearsal_cfg
    from hmvit_tpu_torch.serving import batch_to_device, request_batch

    cfg = rehearsal_cfg()
    model = init_parameters(HMViT(cfg), seed=0).eval()
    batch = request_batch(0, max_points=512, image_size=64, num_cams=2,
                          lidar_range=cfg["lidar"]["lidar_range"])
    with torch.no_grad():
        off = model(batch_to_device(batch, "cpu", False))
        with tracing.on() as tracer:
            on = model(batch_to_device(batch, "cpu", False))
    assert sorted(off) == sorted(on)
    assert all(torch.equal(off[k], on[k]) for k in off)
    record = tracer.collect()
    assert names(record) == ["request", "lidar", "camera", "fusion",
                             "decoder"]
    assert {s["unit"] for s in record["spans"]} == {1}
    # no CUDA events on the CPU: stage times come from a card only
    assert record["stages"] == []


class _TwinInBackward(torch.autograd.Function):
    """The identity, whose backward opens a kernel's backward range as
    the kernel wrappers' backward does."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with tracing.twin_backward("pair_warp"):
            return g.clone()


def test_a_train_step_records_its_phases():
    from hmvit_tpu_torch import perf_lab
    from hmvit_tpu_torch.serving import batch_to_device

    lab = perf_lab.Lab("cpu", perf_lab.TINY, iters=1)
    state, step, batch, labels = perf_lab._train_case(lab)
    state.model.HeteroDecoder_0.register_forward_hook(
        lambda m, args, out: (_TwinInBackward.apply(out[0]), out[1]))
    with tracing.on() as tracer:
        for _ in range(2):
            step(state, batch_to_device(batch, "cpu", False), labels)
    spans = tracer.collect()["spans"]
    phases = ["request", "train.forward", "train.backward", "train.optimizer"]
    assert [s["name"] for s in spans if s["name"] in phases] == phases * 2
    for unit in (1, 2):
        mine = {s["name"]: i for i, s in enumerate(spans)
                if s["unit"] == unit}
        assert set(phases) <= set(mine)
        assert all(spans[mine[p]]["parent"] is None for p in phases)
        twin = [s for s in spans if s["unit"] == unit
                and s["name"] == tracing.TWIN_BACKWARD + "pair_warp"]
        assert len(twin) == 1
        assert twin[0]["parent"] == mine["train.backward"]
        stages = [s["name"] for s in spans if s["unit"] == unit
                  and s["parent"] == mine["train.forward"]]
        assert stages == ["lidar", "camera", "fusion", "decoder"]


class FakeEvent:
    """``torch.cuda.Event``'s part the marks use, on the host."""
    made = []

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        self.external, self.records, self.synced = external, 0, 0
        FakeEvent.made.append(self)

    def record(self):
        self.records += 1

    def synchronize(self):
        self.synced += 1

    def elapsed_time(self, end):
        return 10.0 * FakeEvent.made.index(end) - FakeEvent.made.index(self)


class FakeGraph:
    replays = 0

    def replay(self):
        self.replays += 1


class OnCuda:
    is_cuda = True


def test_marks_recorded_into_a_capture_are_read_each_replay(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("an event was made with the tracer off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    graph = FakeGraph()
    with tracing.gather_marks() as marks, tracing.mark("camera", OnCuda()):
        pass
    tracing.replay(graph, marks)
    assert marks == [] and graph.replays == 1

    FakeEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with tracing.on() as tracer:
        with tracing.gather_marks() as marks:
            for stage in ("camera", "fusion"):
                with tracing.mark(stage, OnCuda()):
                    pass
        assert [m[0] for m in marks] == ["camera", "fusion"]
        assert all(e.external and e.records == 1 for e in FakeEvent.made)
        for _ in range(2):
            with tracing.span("request", new_unit=True):
                pass
            tracing.replay(graph, marks)
    record = tracer.collect()
    assert graph.replays == 3
    # no host span inside a capture; each replay read once
    assert names(record) == ["request", "request"]
    assert [(s["unit"], s["name"], s["graph"]) for s in record["stages"]] \
        == [(1, "camera", True), (1, "fusion", True),
            (2, "camera", True), (2, "fusion", True)]
    assert [s["ms"] for s in record["stages"]] == [10.0, 28.0] * 2


def test_anchor_offset_from_a_trace():
    def x(name, ts, dur):
        return {"ph": "X", "name": name, "cat": "cuda_runtime", "ts": ts,
                "dur": dur}

    sync = "cudaDeviceSynchronize"
    trace = {"traceEvents": [
        x("cudaLaunchKernel", 500.0, 3.0),
        # two syncs in a row elsewhere: too short a run
        x(sync, 600.0, 5.0), x(sync, 700.0, 5.0),
        x("cudaMemcpyAsync", 710.0, 9.0),
        # a caller's sync and the anchor's untimed one, the anchor's three
        # after pauses of 0, 500 and 1000 us, and a caller's sync
        x(sync, 980.0, 5.0), x(sync, 990.0, 5.0), x(sync, 1000.0, 4.0),
        x(sync, 1510.0, 4.0), x(sync, 2520.0, 4.0), x(sync, 2530.0, 4.0),
        {"ph": "X", "name": "gemm", "cat": "kernel", "ts": 2540.0,
         "dur": 5.0},
        x("cudaLaunchKernel", 2550.0, 4.0)]}
    # [1000, 1004] inside [100, 108] + offset: offset in [896, 900];
    # [1510, 1514] inside [609, 617]: [897, 901]; [2520, 2524] inside
    # [1619, 1626]: [898, 901]; so [898, 900].  Shifted by one sync, no
    # offset fits the pauses.
    anchor = ((100.0, 108.0), (609.0, 617.0), (1619.0, 1626.0))
    assert tracing.trace_offset_us(trace, anchor) == 899.0
    # intervals no run of the trace fits
    with pytest.raises(ValueError):
        tracing.trace_offset_us(trace, ((100.0, 101.0), (150.0, 151.0),
                                        (200.0, 201.0)))
    trace["traceEvents"] = trace["traceEvents"][:4]
    with pytest.raises(ValueError):
        tracing.trace_offset_us(trace, anchor)


def test_syncs_count_against_the_innermost_span():
    before = warnings.showwarning
    filters = list(warnings.filters)
    with pytest.warns(UserWarning, match="not a sync"):
        with tracing.on() as tracer:
            warnings.warn(tracing.SYNC_MESSAGE)
            with tracing.span("request", new_unit=True):
                for _ in range(2):  # the same place twice: both counted
                    warnings.warn(tracing.SYNC_MESSAGE + " (internal)")
                with tracing.span("inner"):
                    warnings.warn(tracing.SYNC_MESSAGE)
            warnings.warn("not a sync")
    record = tracer.collect()
    assert [s["syncs"] for s in record["spans"]] == [2, 1]
    assert record["syncs_outside"] == 1
    assert warnings.showwarning is before
    assert list(warnings.filters) == filters
    with pytest.raises(RuntimeError):
        with tracing.on(), tracing.on():
            pass
    assert not tracing.active()
