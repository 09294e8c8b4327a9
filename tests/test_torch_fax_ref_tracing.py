"""The FAX twin's tracer marks and counter (``models/fax_ref.py``): with
the tracer on, the trunk, each scale's cross-view block, the
self-attention and the decoder are spans nested in ``camera``, in the
order they run, and ``fax.score_elems`` counts the float32 score
elements of every attention by its formula; off, nothing is made and the
outputs keep their bits; perf_lab's block is the camera of the
benchmark's ``hmvit_fax_ref`` configuration.  On the card (``-m gpu``,
skipped elsewhere): no FAX span waits on the device at the published
widths, and a graph captured with the tracer off has no event node,
where the traced one has two a mark.

    python -m pytest tests/test_torch_fax_ref_tracing.py -q -m gpu -s \\
        --noconftest
"""
import json
import os

import pytest
import torch

from hmvit_tpu_torch import tracing
from hmvit_tpu_torch.models.fax_ref import FAXRefCameraEncoder
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.perf_lab import FAX_MARKS, FAX_REF_CAMERA

# the FAX twin at rehearsal widths: a 4^2 BEV prior whose decoder's two
# doublings reach the rehearsal model's 16^2 fusion map
TINY = dict(FAX_REF_CAMERA, dim=32, bev_size=4, out_dim=64, heads=2,
            dim_head=16)
# another width: a 8^2 prior, windows of 2, 4 heads
WIDER = dict(FAX_REF_CAMERA, dim=64, bev_size=8, out_dim=64, heads=4,
             dim_head=16, window=2)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def score_elems(cfg: dict, agents: int, cams: int, feat_sides) -> int:
    """The float32 score elements of one FAX forward: at each scale two
    cross-view attentions of (agents x heads) windows, each window's
    cams x win^2 queries against cams x fw^2 keys (fw = the feature
    window: equal window counts on both sides), then the self-attention
    over the last scale's bev^2 tokens with dim / dim_head heads."""
    bev, win, scales = cfg["bev_size"], cfg["window"], len(feat_sides)
    total = 0
    for i, fh in enumerate(feat_sides):
        side = bev * 2 ** (scales - 1 - i)
        fw = max(1, fh * win // side)
        windows = (side // win) ** 2
        assert windows == (fh // fw) ** 2
        total += 2 * agents * cfg["heads"] * windows * (cams * win * win) \
            * (cams * fw * fw)
    return total + agents * (cfg["dim"] // cfg["dim_head"]) * bev ** 4


def camera_inputs(agents: int, cams: int, size: int, device="cpu",
                  dtype=torch.float32):
    """Seeded images and an invertible calibration: a pinhole of focal
    size / 2 and each camera turned and set off the agent's centre."""
    gen = torch.Generator().manual_seed(0)
    images = torch.rand(agents, cams, size, size, 3, generator=gen)
    intr = torch.tensor([[size / 2, 0.0, size / 2], [0.0, size / 2, size / 2],
                         [0.0, 0.0, 1.0]]).expand(agents, cams, 3, 3)
    extr = torch.eye(4).repeat(agents, cams, 1, 1)
    angle = torch.rand(agents, cams, generator=gen) * 6.28
    extr[..., 0, 0], extr[..., 0, 1] = angle.cos(), -angle.sin()
    extr[..., 1, 0], extr[..., 1, 1] = angle.sin(), angle.cos()
    extr[..., :3, 3] = torch.rand(agents, cams, 3, generator=gen)
    return (images.to(device, dtype), intr.contiguous().to(device),
            extr.to(device))


def tiny_hmvit():
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.perf_lab import rehearsal_cfg
    from hmvit_tpu_torch.serving import request_batch, serving_hints

    cfg = dict(rehearsal_cfg(), camera=TINY)
    batch = request_batch(0, max_points=512, image_size=64, num_cams=2,
                          lidar_range=cfg["lidar"]["lidar_range"])
    batch["mode"][:, :4] = 0
    model = init_parameters(HMViT(cfg), seed=0).eval()
    return model, batch, serving_hints(batch["mode"][0], 4)


def test_sub_stages_are_spans_nested_in_camera_in_order():
    from hmvit_tpu_torch.serving import batch_to_device

    model, batch, hints = tiny_hmvit()
    with torch.no_grad(), tracing.on() as tracer:
        model(batch_to_device(batch, "cpu", False), **hints)
    spans = tracer.collect()["spans"]
    names = [s["name"] for s in spans]
    camera = names.index("camera")
    inside = [s["name"] for s in spans if s["parent"] == camera]
    assert inside == list(FAX_MARKS)
    # a camera fleet: the lidar encoder never runs
    assert names == ["request", "camera", *FAX_MARKS, "fusion", "decoder"]
    assert all(s["syncs"] == 0 for s in spans)


def test_off_makes_nothing_and_keeps_the_bits(monkeypatch):
    from hmvit_tpu_torch.serving import batch_to_device

    model, batch, hints = tiny_hmvit()
    with torch.no_grad(), tracing.on() as tracer:
        on = model(batch_to_device(batch, "cpu", False), **hints)
    assert tracer.collect()["spans"]

    def refuse(*a, **k):
        raise AssertionError("the tracer made something while off")

    for name in ("_Span", "_Mark"):
        monkeypatch.setattr(tracing, name, refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with torch.no_grad():
        off = model(batch_to_device(batch, "cpu", False), **hints)
    assert all(torch.equal(off[k], on[k]) for k in off)
    assert tracing.mark(tracing.CAMERA_TRUNK, torch.zeros(1)) \
        is tracing.span("camera")


@pytest.mark.parametrize("cfg", [TINY, WIDER], ids=["tiny", "wider"])
def test_score_elems_follow_the_formula(cfg):
    encoder = init_parameters(FAXRefCameraEncoder(cfg), seed=0).eval()
    agents, cams, size = 3, 2, 64
    with torch.no_grad(), tracing.on() as tracer:
        with tracing.span("camera"):
            out = encoder(*camera_inputs(agents, cams, size))
    record = tracer.collect()
    side = cfg["bev_size"] * 2 ** cfg["decoder_layers"]
    assert out.shape == (agents, side, side, cfg["out_dim"])
    by_span = {s["name"]: s["counts"].get(tracing.FAX_SCORE_ELEMS, 0)
               for s in record["spans"]}
    # 64^2 images: ResNet stages 2 and 3 give 8^2 and 4^2 features
    want = score_elems(cfg, agents, cams, (8, 4))
    assert sum(by_span.values()) == want
    assert by_span["camera"] == 0 and by_span[tracing.CAMERA_TRUNK] == 0
    assert by_span[tracing.CAMERA_SELF_ATTN] == \
        agents * (cfg["dim"] // cfg["dim_head"]) * cfg["bev_size"] ** 4
    assert record["counts_outside"] == {}


def test_count_goes_to_the_innermost_span():
    tracing.count("x", 5)  # off: nothing
    with tracing.on() as tracer:
        tracing.count("x", 1)
        with tracing.span("a"):
            tracing.count("x", 2)
            with tracing.span("b"):
                tracing.count("x", 3)
                tracing.count("y", 4)
    record = tracer.collect()
    assert [s["counts"] for s in record["spans"]] == [{"x": 2},
                                                      {"x": 3, "y": 4}]
    assert record["counts_outside"] == {"x": 1}


def test_the_block_is_the_benchmark_configurations_camera():
    """perf_lab's FAX block (the tracer stage's, and this file's widths)
    is the camera of the configuration the ``hmvit_fax_ref`` cell
    serves."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "benchmark", "configs",
        "hmvit_fax_ref.json")
    with open(path) as f:
        assert json.load(f)["model"]["camera"] == FAX_REF_CAMERA


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events, syncs and graphs "
                    "run only on the card)")
    return torch.device("cuda", 0)


def card_encoder(dev):
    """The FAX twin at its published widths in bfloat16, as the
    ``hmvit_fax_ref`` configuration serves it, and a fleet of 4 camera
    agents with 4 512^2 images each."""
    encoder = init_parameters(FAXRefCameraEncoder(FAX_REF_CAMERA), seed=0)
    encoder = encoder.to(dev, torch.bfloat16).eval().requires_grad_(False)
    images, intr, extr = camera_inputs(4, 4, 512, dev, torch.bfloat16)
    return encoder, (images, intr, extr)


@pytest.mark.gpu
def test_fax_spans_count_no_syncs(dev):
    encoder, inputs = card_encoder(dev)
    encoder(*inputs)  # the grids and the cached (x, y) made
    torch.cuda.synchronize()
    with tracing.on() as tracer:
        with tracing.span("camera"):
            encoder(*inputs)
        torch.cuda.synchronize()
    record = tracer.collect()
    spans = {s["name"]: s for s in record["spans"]}
    print({name: (round(s["end_us"] - s["start_us"], 1), s["syncs"])
           for name, s in spans.items()}, torch.cuda.get_device_name())
    assert list(spans) == ["camera", *FAX_MARKS]
    assert all(s["syncs"] == 0 for s in spans.values())
    assert sum(s["counts"].get(tracing.FAX_SCORE_ELEMS, 0)
               for s in spans.values()) == \
        score_elems(FAX_REF_CAMERA, 4, 4, (64, 32))
    # eager marks on the card keep each sub-stage's device time too
    stages = [s["name"] for s in record["stages"]]
    assert stages == list(FAX_MARKS)


@pytest.mark.gpu
def test_a_graph_captured_off_has_no_event_nodes(dev, tmp_path,
                                                 monkeypatch):
    encoder, inputs = card_encoder(dev)

    def capture(path):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            encoder(*inputs)
        torch.cuda.current_stream().wait_stream(side)
        # the captured cudaGraph_t kept for its dump (instantiated at the
        # first replay)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        graph.enable_debug_mode()
        with torch.cuda.graph(graph):
            out = encoder(*inputs)
        graph.debug_dump(str(path))
        graph.replay()
        torch.cuda.synchronize()
        return out.clone(), path.read_text().lower()

    with tracing.on(), tracing.gather_marks() as marks:
        traced, on = capture(tmp_path / "on.dot")
    assert [m[0] for m in marks] == list(FAX_MARKS)

    def refuse(*a, **k):
        raise AssertionError("an event was made with the tracer off")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    plain, off = capture(tmp_path / "off.dot")
    assert torch.equal(plain, traced)
    print(f"event mentions: traced {on.count('event')}, off "
          f"{off.count('event')}; traced lines: "
          f"{[line[:160] for line in on.splitlines() if 'event' in line][:4]}")
    assert off.count("event") == 0 < on.count("event")
