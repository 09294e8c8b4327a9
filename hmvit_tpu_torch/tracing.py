"""The port's tracer: host spans at its layer boundaries, device stage
marks that survive a CUDA-graph capture, and a count of device-to-host
syncs by span.  Off by default; this module owns every span and range
name the program emits.

Off, :func:`span` and :func:`mark` return one shared null context after
one module-level check (no allocation, no clock read, no profiler call),
and a graph captured off has no event nodes.  :func:`on` turns the
tracer on for a block and yields the :class:`Tracer` that records it:

- **spans** (:func:`span`): name, start and end on the host clock
  (:func:`clock_us`, microseconds), the enclosing span, the frame or
  step id (``unit``: a span opened with ``new_unit=True``, the
  ``request`` span of ``serving.batch_to_device``, starts the next one)
  and the syncs counted against it.  Each span also enters a
  ``torch.profiler.record_function`` of its name.  One stack serves the
  process: a CUDA backward runs on the autograd engine's thread while
  its caller waits in ``backward()``, so its spans nest under the
  caller's;
- **marks** (:func:`mark`): a stage's begin and end as timing CUDA
  events, recorded with ``external=True`` inside a capture, so the
  capture records them into the graph as event-record nodes; replayed
  through :func:`replay`, each replay's stage time is read after the
  device is done with it.  An eager mark also opens a host span of its
  name;
- **syncs**: ``torch.cuda.set_sync_debug_mode("warn")``, each warning
  counted against the innermost open span (restored, with the warning
  filters, when the block ends);
- **counters** (:func:`count`): a named number the host works out from
  shapes (it reads nothing back), added to the innermost open span's
  ``counts``; made where the host runs the code (an eager pass or a
  capture), never by a graph's replay;
- **the clock**: :func:`anchor` times a few device synchronisations
  between clock reads; :func:`trace_offset_us` finds their runtime
  events in an exported profiler trace and gives the offset from the
  host clock to the trace's ``ts``.

``twin_backward:<kernel>`` ranges (:func:`twin_backward`) are emitted
whether the tracer is on or off; on, they are spans too.
"""
from __future__ import annotations

import contextlib
import time
import warnings

import torch

TWIN_BACKWARD = "twin_backward:"
SYNC_MESSAGE = "called a synchronizing CUDA operation"
ANCHOR_CALL = "cudaDeviceSynchronize"
ANCHOR_SYNCS = 3
ANCHOR_PAUSE_S = 5e-4
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the FAX twin's marks inside ``camera`` (``models/fax_ref.py``): the
# ResNet trunk, each image scale's cross-view block (its bottlenecks and
# downsample included; the scale's index appended), the full-map
# self-attention, and ``out_proj`` + ``NaiveDecoder``
CAMERA_TRUNK = "camera.trunk"
CAMERA_CROSS_VIEW = "camera.cross_view."
CAMERA_SELF_ATTN = "camera.self_attn"
CAMERA_DECODER = "camera.decoder"
# counter: the float32 attention-score elements each FAX attention makes
FAX_SCORE_ELEMS = "fax.score_elems"

_NULL = contextlib.nullcontext()
_ACTIVE: Tracer | None = None


def clock_us() -> float:
    """The host clock every span reads, in microseconds."""
    return time.perf_counter_ns() * 1e-3


def active() -> bool:
    return _ACTIVE is not None


def span(name: str, new_unit: bool = False):
    """A host span of ``name`` around the block (``new_unit``: it starts
    the next frame or step id); the shared null context when off."""
    if _ACTIVE is None:
        return _NULL
    return _Span(_ACTIVE, name, new_unit)


def mark(name: str, like):
    """The begin and end of stage ``name`` on the device (when ``like``,
    a tensor of the stage, lies on a CUDA device) and a host span of the
    same name outside a capture; the shared null context when off."""
    if _ACTIVE is None:
        return _NULL
    return _Mark(_ACTIVE, name, bool(like.is_cuda))


def count(name: str, n: int):
    """Add ``n`` to counter ``name`` of the innermost open span (outside
    any span: :attr:`Tracer.counts_outside`); nothing when off."""
    t = _ACTIVE
    if t is None:
        return
    counts = t.spans[t.open[-1]]["counts"] if t.open else t.counts_outside
    counts[name] = counts.get(name, 0) + n


def twin_backward(kernel: str):
    """Profiler range around the backward of ``kernel``'s wrapper (its
    plain twin's forward recompute and backward), always emitted; with
    the tracer on it is a span of the same name."""
    name = TWIN_BACKWARD + kernel
    if _ACTIVE is None:
        return torch.profiler.record_function(name)
    return _Span(_ACTIVE, name, False)


@contextlib.contextmanager
def gather_marks():
    """Around a capture: yields the list the marks recorded into the
    graph land in, as (name, begin event, end event) (empty with the
    tracer off), for :func:`replay`."""
    marks = []
    t = _ACTIVE
    if t is None:
        yield marks
        return
    previous, t.gathering = t.gathering, marks
    try:
        yield marks
    finally:
        t.gathering = previous


def replay(graph, marks: list):
    """Replay ``graph``; with the tracer on and ``marks`` (the graph's, as
    :func:`gather_marks` gave them), the stage times of this replay are
    kept, read once the device is done with them."""
    t = _ACTIVE
    if t is None or not marks:
        graph.replay()
        return
    t.settle(marks)  # the previous replay's times, before they are rewritten
    graph.replay()
    t.pending[id(marks)] = (t.unit, marks)


def anchor():
    """With the tracer on and a CUDA device: time :data:`ANCHOR_SYNCS`
    device synchronisations on an idle device, each between two clock
    reads, the i-th after a pause of i x :data:`ANCHOR_PAUSE_S` (a
    spacing no neighbouring synchronisation shares), kept (one tuple of
    intervals) in :attr:`Tracer.anchors` for :func:`trace_offset_us`."""
    t = _ACTIVE
    if t is None or not torch.cuda.is_available():
        return
    torch.cuda.synchronize()  # the device idle: each timed call returns
    intervals = []
    for i in range(ANCHOR_SYNCS):
        time.sleep(i * ANCHOR_PAUSE_S)
        t0 = clock_us()
        torch.cuda.synchronize()
        intervals.append((t0, clock_us()))
    t.anchors.append(tuple(intervals))


def trace_offset_us(trace: dict, anchor: tuple) -> float:
    """Trace ``ts`` minus host clock, from an exported chrome trace
    (``trace``) of a stretch in which :func:`anchor` ran (``anchor``: its
    host intervals).  Its calls are a run of ``cudaDeviceSynchronize``
    runtime events with no other runtime event between them (the
    runtime's events are kept in a device-only trace too; a kernel's
    record can be missing from a long process's trace).  Each call's
    event lies inside its interval, so the offset lies between (end - t1)
    and (start - t0) of every pair; the run whose pairs allow an offset
    gives the middle of that range.  Raises ValueError unless exactly one
    run does."""
    calls = sorted((ev for ev in trace.get("traceEvents", [])
                    if ev.get("ph") == "X" and "ts" in ev
                    and ev.get("cat") in RUNTIME_CATEGORIES),
                   key=lambda ev: float(ev["ts"]))
    runs, run = [], []
    for ev in calls + [{"name": None}]:
        if ev["name"] == ANCHOR_CALL:
            run.append(ev)
            continue
        if len(run) >= len(anchor):
            runs.append(run)
        run = []
    offsets = []
    for run in runs:
        for first in range(len(run) - len(anchor) + 1):
            lo, hi = float("-inf"), float("inf")
            for (t0, t1), ev in zip(anchor, run[first:]):
                start = float(ev["ts"])
                end = start + float(ev.get("dur", 0.0))
                lo, hi = max(lo, end - t1), min(hi, start - t0)
            if lo <= hi:
                offsets.append(0.5 * (lo + hi))
    if len(offsets) != 1:
        raise ValueError(f"{len(offsets)} runs of {ANCHOR_CALL} in the "
                         f"trace fit the anchor, not one")
    return offsets[0]


def self_us(spans: list[dict]) -> list[float]:
    """Each span's duration less the part of it its child spans cover."""
    children = [[] for _ in spans]
    for s in spans:
        if s["parent"] is not None:
            children[s["parent"]].append((s["start_us"], s["end_us"]))
    out = []
    for s, kids in zip(spans, children):
        lo, hi = s["start_us"], s["end_us"]
        covered, edge = 0.0, lo
        for a, b in sorted(kids):
            a, b = max(a, edge), min(b, hi)
            if b > a:
                covered += b - a
                edge = b
        out.append(hi - lo - covered)
    return out


@contextlib.contextmanager
def on():
    """Turn the tracer on for the block; yields its :class:`Tracer`."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("the tracer is on already")
    tracer = Tracer()
    tracer.start()
    _ACTIVE = tracer
    try:
        yield tracer
    finally:
        _ACTIVE = None
        tracer.stop()


class Tracer:
    """What one :func:`on` block recorded (see the module's docstring);
    :meth:`collect` hands it out."""

    def __init__(self):
        self.spans: list[dict] = []
        self.stages: list[dict] = []
        self.anchors: list[tuple] = []
        self.syncs_outside = 0
        self.counts_outside: dict[str, int] = {}
        self.unit = 0
        self.open: list[int] = []
        self.gathering: list | None = None
        self.pending: dict[int, tuple[int, list]] = {}
        self.eager: list[tuple] = []
        self._warnings = None
        self._show = None
        self._sync_mode = None

    def start(self):
        self._warnings = warnings.catch_warnings()
        self._warnings.__enter__()
        warnings.filterwarnings("always", message=SYNC_MESSAGE)
        self._show = warnings.showwarning
        warnings.showwarning = self._on_warning
        if torch.cuda.is_available():
            self._sync_mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self):
        if self._sync_mode is not None:
            torch.cuda.set_sync_debug_mode(self._sync_mode)
        self._warnings.__exit__(None, None, None)

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if not str(message).startswith(SYNC_MESSAGE):
            self._show(message, category, filename, lineno, file, line)
        elif self.open:
            self.spans[self.open[-1]]["syncs"] += 1
        else:
            self.syncs_outside += 1

    def settle(self, marks: list):
        """Read the stage times of the pending replay of ``marks``."""
        unit, _ = self.pending.pop(id(marks), (None, None))
        if unit is None:
            return
        marks[-1][2].synchronize()
        self.stages += [{"unit": unit, "name": name, "graph": True,
                         "ms": begin.elapsed_time(end)}
                        for name, begin, end in marks]

    def collect(self) -> dict:
        """Everything recorded so far, the device's stage times read
        (waits for the device): ``spans``, ``stages`` ({unit, name, ms,
        graph: from a replay}), ``anchors``, ``syncs_outside``,
        ``counts_outside``."""
        if (self.pending or self.eager) and torch.cuda.is_available():
            torch.cuda.synchronize()
        for key in list(self.pending):
            self.settle(self.pending[key][1])
        self.stages += [{"unit": unit, "name": name, "graph": False,
                         "ms": begin.elapsed_time(end)}
                        for unit, name, begin, end in self.eager]
        self.eager.clear()
        return {"spans": list(self.spans), "stages": list(self.stages),
                "anchors": list(self.anchors),
                "syncs_outside": self.syncs_outside,
                "counts_outside": dict(self.counts_outside)}


class _Span:
    __slots__ = ("tracer", "name", "new_unit", "index", "range")

    def __init__(self, tracer: Tracer, name: str, new_unit: bool):
        self.tracer, self.name, self.new_unit = tracer, name, new_unit

    def __enter__(self):
        t = self.tracer
        if self.new_unit:
            t.unit += 1
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.index = len(t.spans)
        t.spans.append({"name": self.name, "start_us": clock_us(),
                        "end_us": None,
                        "parent": t.open[-1] if t.open else None,
                        "unit": t.unit, "syncs": 0, "counts": {}})
        t.open.append(self.index)
        return self

    def __exit__(self, *exc):
        t = self.tracer
        t.spans[self.index]["end_us"] = clock_us()
        t.open.remove(self.index)
        self.range.__exit__(*exc)
        return False


class _Mark:
    __slots__ = ("tracer", "name", "cuda", "capturing", "begin", "span")

    def __init__(self, tracer: Tracer, name: str, cuda: bool):
        self.tracer, self.name, self.cuda = tracer, name, cuda
        self.capturing = cuda and torch.cuda.is_current_stream_capturing()
        self.begin = self.span = None

    def __enter__(self):
        if self.cuda:
            self.begin = torch.cuda.Event(enable_timing=True,
                                          external=self.capturing)
            self.begin.record()
        if not self.capturing:
            self.span = _Span(self.tracer, self.name, False).__enter__()
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            self.span.__exit__(*exc)
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True,
                                   external=self.capturing)
            end.record()
            t = self.tracer
            if not self.capturing:
                t.eager.append((t.unit, self.name, self.begin, end))
            elif t.gathering is not None:
                t.gathering.append((self.name, self.begin, end))
        return False
