"""The serving forward as a captured CUDA graph: the port's ``jax.jit``.

The JAX package runs the forward as one compiled program per shape
bucket (``bench.py``: ``jax.jit`` over ``model.apply`` with the serving
hints).  :class:`CompiledServer` is its counterpart here: for each
request bucket (the fleet layout the hints describe, and the batch
size) it warms the model up on a side stream, captures the forward in
one CUDA graph and anchor decode + rotated NMS in a second, and then
answers each request by copying its tensors into the graph's static
input buffers and replaying both graphs.  It never runs the model
eagerly in a graph's place: a capture that fails raises.

Launch counts: :class:`hmvit_tpu_torch.ops.cuda.Kernel` counts a launch
when the host issues it, so a capture counts each kernel of the graph
once and a replay counts nothing.  Each bucket keeps the counts of its
capture (``launches`` by kernel, ``bodies``: the attention kernels' by
body), what every replay of it launches; the server keeps its own
replay count (:attr:`CompiledServer.replays`).

Tracing (:mod:`hmvit_tpu_torch.tracing`): a bucket captured with the
tracer on is a twin of the one captured off (its key says so), whose
graphs hold the stage marks as event-record nodes; a replay of it keeps
each stage's device time.  Off, the graphs have no such node.
"""
from __future__ import annotations

import torch

from . import tracing
from .ops import cuda
from .postprocess import decode_detections_device

HINT_KEYS = ("camera_bucket", "active_agents", "static_ego_modality",
             "static_modes")
# eager forwards before a capture: cuDNN's algorithm choice, the
# allocator and the port's device constants settle in them
WARMUP = 3


def _bucket_key(request: dict, hints: dict) -> tuple:
    """What a graph is specialised to: the hints and every input's shape
    and type (the batch size among them); with the tracer on, also that
    (its graphs hold the stage marks' event nodes)."""
    shapes = tuple((k, tuple(v.shape), v.dtype)
                   for k, v in sorted(request.items()))
    key = tuple(hints.get(k) for k in HINT_KEYS) + shapes
    return key + ("traced",) if tracing.active() else key


def _require_cuda(request: dict, what: str):
    cpu = sorted(k for k, v in request.items() if not v.is_cuda)
    if cpu:
        raise ValueError(f"{what}: the graph server takes CUDA tensors only; "
                         f"{cpu} are not on a CUDA device")


def _detect(out, anchors, transform):
    """Decode + NMS of each frame of a batch: [(corners, scores, valid)]."""
    with tracing.mark("decode_nms", out["psm"]):
        return [decode_detections_device(out["psm"][i:i + 1],
                                         out["rm"][i:i + 1], anchors,
                                         transform)
                for i in range(out["psm"].shape[0])]


class _Bucket:
    """The two captured graphs of one request bucket and their static
    tensors."""

    def __init__(self, model, hints, example, anchors, transform):
        self.inputs = {k: v.clone() for k, v in example.items()}
        self.hints = dict(hints)
        # the warm-up runs on a side stream, as torch.cuda.graph asks
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), torch.no_grad():
            for _ in range(WARMUP):
                _detect(model(self.inputs, **self.hints), anchors,
                        transform)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        before = cuda.launch_counts()
        bodies_before = cuda.attention_body_launches()
        self.forward_graph = torch.cuda.CUDAGraph()
        self.detect_graph = torch.cuda.CUDAGraph()
        try:
            with torch.no_grad():
                with tracing.gather_marks() as self.forward_marks, \
                        torch.cuda.graph(self.forward_graph):
                    self.out = model(self.inputs, **self.hints)
                with tracing.gather_marks() as self.detect_marks, \
                        torch.cuda.graph(self.detect_graph):
                    self.det = _detect(self.out, anchors, transform)
        except RuntimeError as err:
            raise RuntimeError(
                "CUDA-graph capture of the serving forward or of decode + "
                f"NMS failed (hints {self.hints}): {err}") from err
        after = cuda.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after}
        bodies = cuda.attention_body_launches()
        self.bodies = {k: {b: n - bodies_before[k][b] for b, n in v.items()}
                       for k, v in bodies.items()}


class CompiledServer:
    """One model (one serving variant) whose forward and decode + NMS run
    as captured CUDA graphs, one pair per request bucket.

    ``model`` is an eval-mode :class:`HMViT` on a CUDA device; ``hints``
    the static hints of :func:`hmvit_tpu_torch.serving.serving_hints`;
    ``example`` a request (a dict of CUDA tensors, as
    :func:`serving.batch_to_device` gives) of the bucket to capture
    first; ``anchors`` (H, W, A, 7) and ``transform`` (4, 4) to the ego
    frame are the decode's (serving thresholds), held by the graphs as
    they are (do not write to them).

    Outputs are the graphs' static tensors, NOT copies: the forward's
    ``{"psm", "rm"}`` and decode's ``[(corners, scores, valid)]`` (one
    tuple a frame of the batch) of a bucket are overwritten in place by
    that bucket's next replay.  Read or ``clone()`` them before the next
    request, never write to them, and never hand them to another stream
    without synchronising."""

    def __init__(self, model, hints: dict, example: dict, anchors,
                 transform):
        if model.config.get("debug_checks", False):
            raise ValueError(
                "CompiledServer: the model has debug_checks on; its "
                "camera_bucket / static_modes check reads the batch's mode "
                "back to the host, which a captured graph cannot do")
        _require_cuda(example, "CompiledServer")
        if not (anchors.is_cuda and transform.is_cuda):
            raise ValueError("CompiledServer: anchors and transform must lie "
                             "on a CUDA device")
        # the build runs nvcc processes: never inside a capture
        cuda.load_library()
        self.model = model
        self.hints = dict(hints)
        self.anchors = anchors
        self.transform = transform
        self.buckets: dict[tuple, _Bucket] = {}
        self.replays = 0
        self.bucket(example, self.hints)

    def bucket(self, request: dict, hints: dict) -> _Bucket:
        """The captured bucket of ``request`` under ``hints``, captured
        now (with ``request`` as its example) if it is new."""
        _require_cuda(request, "CompiledServer")
        key = _bucket_key(request, hints)
        if key not in self.buckets:
            self.buckets[key] = _Bucket(self.model, hints, request,
                                        self.anchors, self.transform)
        return self.buckets[key]

    def load(self, request: dict, hints: dict | None = None) -> _Bucket:
        """Copy ``request`` into its bucket's static inputs (capturing the
        bucket first if it is new)."""
        with tracing.span("serve.load"):
            b = self.bucket(request, self.hints if hints is None else hints)
            for k, v in request.items():
                b.inputs[k].copy_(v, non_blocking=True)
        return b

    def replay_forward(self, b: _Bucket) -> dict:
        """Replay the forward alone (the part ``bench.py`` times)."""
        with tracing.span("serve.replay"):
            tracing.replay(b.forward_graph, b.forward_marks)
        self.replays += 1
        return b.out

    def __call__(self, request: dict, hints: dict | None = None):
        """Answer one request: (outputs {"psm", "rm"}, [(corners, scores,
        valid)] a frame), the bucket's static tensors (see the class)."""
        b = self.load(request, hints)
        self.replay_forward(b)
        with tracing.span("serve.replay"):
            tracing.replay(b.detect_graph, b.detect_marks)
        return b.out, b.det
