"""The camera-fleet cells at tiny CPU widths: the reference's FAX twin
(``reference/models/fax_ref.py``) and the planar lift against the port on
the benchmark's seeded weights and the generator's pool (the serving
forward and decode + NMS), and each cell's runner end to end on the CPU
rehearsal."""
import pytest
import torch

from benchmark import compare, generator, manifest, run, serve, weights
from benchmark.tests.rehearsal import cpu_spec, on_cpu

CELLS = ["hmvit_fax_ref.camera_serve", "hmvit_planar.camera_serve"]


def tiny_spec(cell: str) -> dict:
    """``cpu_spec`` of the cell; the FAX twin also at a 4^2 BEV prior
    (its decoder's two doublings reach the rehearsal's 16^2 fusion map)
    and heads of 16 (two self-attention heads at dim 32)."""
    spec = cpu_spec(cell)
    camera = spec["config"]["model"]["camera"]
    if camera["encoder"] == "fax_ref":
        camera.update(bev_size=4, dim_head=16)
    return spec


@pytest.fixture(scope="module", params=CELLS)
def spec(request):
    return tiny_spec(request.param)


def test_the_port_tracer_lab_runs_this_camera_block():
    """``perf_lab tracer``'s FAX sub-stages run the configuration's own
    camera block."""
    from hmvit_tpu_torch.perf_lab import FAX_REF_CAMERA

    assert manifest.cell(CELLS[0])["config"]["model"]["camera"] == \
        FAX_REF_CAMERA


def test_camera_fleet_traffic(spec):
    h = compare.hints(spec["traffic"])
    assert h == dict(camera_bucket=4, active_agents=4, static_ego_modality=0,
                     static_modes=(0, 0, 0, 0))
    req = generator.make_pool(3, spec["traffic"])[0]
    assert req["mode"][0].tolist()[:4] == [0, 0, 0, 0]


def test_serving_forward_and_decode_equal_the_port(spec):
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.postprocess import decode_detections_device

    config, traffic = spec["config"], spec["traffic"]
    port = HMViT(compare.reference_config(config["model"]))
    weights.load(port, weights.make_weights(weights.float_shapes(port), 9,
                                            "cpu", torch.float32))
    ref = compare.reference_model(config["model"], 9, "cpu")
    pool = generator.make_pool(9, traffic)
    h = compare.hints(traffic)
    with torch.no_grad():
        for req in pool:
            want = ref(compare.to_device(req, "cpu"), **h)
            got = port(compare.to_device(req, "cpu"), **h)
            for k in ("psm", "rm"):
                torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    anchors = torch.as_tensor(
        compare.generate_anchor_grid(config["anchor_args"], "hwl"),
        dtype=torch.float32)
    a = decode_detections_device(got["psm"], got["rm"], anchors, torch.eye(4))
    b = compare.decode_detections_device(got["psm"], got["rm"], anchors,
                                         torch.eye(4))
    assert compare.box_gap(compare.kept_boxes(*a),
                           compare.kept_boxes(*b)) == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_the_cell_runs_through_its_runner(monkeypatch, cell):
    spec = tiny_spec(cell)
    with on_cpu(monkeypatch) as dev:
        out = serve.run(spec, 2 ** 31 + 5, 1.0, False, 0.0, dev)
    correct, table = run.judge(out["compared"], spec["limits"])
    assert correct, table
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["end_to_end"]) == {"frames_per_s", "frame_p95_ms"}
