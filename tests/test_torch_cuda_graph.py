"""The graph server on the card: for each serving variant (split,
``use_fused_wa``, expansion v1 and v2) at the production shapes in
bfloat16, the replayed CUDA graphs give the eager forward's psm and rm
and the eager decode + NMS bit for bit on 3 requests, and the capture
counted each variant's hand-written kernels once.  These need an NVIDIA
GPU and nvcc and skip elsewhere; the card's machine has no JAX, so run
them there without the suite's conftest:
``python -m pytest tests/test_torch_cuda_graph.py -q -m gpu --noconftest``."""
import pytest
import torch

from hmvit_tpu_torch.data.anchors import generate_anchor_grid
from hmvit_tpu_torch.graph_server import CompiledServer
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import decode_detections_device
from hmvit_tpu_torch.serving import (
    PROD_CFG,
    anchor_args,
    batch_to_device,
    request_batch,
    serving_config,
    serving_hints,
)

pytestmark = pytest.mark.gpu

VARIANTS = {"split": {}, "fused_wa": {"fused_wa": True},
            "expand_v1": {"expand": "v1"}, "expand_v2": {"expand": "v2"}}
SPLIT = {"pair_warp": 4, "stripe_window_attention": 2,
         "plain_window_attention": 5}
CAPTURED = {"split": SPLIT,
            "fused_wa": dict(SPLIT, pair_warp=2, stripe_window_attention=0,
                             warp_window_attention=2),
            "expand_v1": dict(SPLIT, expand_rows=1),
            "expand_v2": dict(SPLIT, expand_rows_v2=1)}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only on the card)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def requests(dev):
    batches = [request_batch(seed) for seed in range(3)]
    return ([batch_to_device(b, dev, bf16=True) for b in batches],
            serving_hints(batches[0]["mode"][0], 4))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_graph_replay_equals_eager(name, dev, requests):
    reqs, hints = requests
    model = init_parameters(HMViT(serving_config(
        PROD_CFG, bf16=True, **VARIANTS[name])), seed=0)
    model = model.to(dev, torch.bfloat16).eval()
    anchors = torch.as_tensor(generate_anchor_grid(anchor_args(PROD_CFG),
                                                   "hwl"),
                              dtype=torch.float32, device=dev)
    eye = torch.eye(4, device=dev)
    with torch.no_grad():
        eager = []
        for b in reqs:
            out = model(b, **hints)
            eager.append((out, decode_detections_device(
                out["psm"], out["rm"], anchors, eye)))
    server = CompiledServer(model, hints, reqs[0], anchors, eye)
    (bucket,) = server.buckets.values()
    assert bucket.launches == {k: CAPTURED[name].get(k, 0)
                               for k in bucket.launches}
    for b, (want, want_det) in zip(reqs, eager):
        out, (det,) = server(b)
        torch.cuda.synchronize()
        for key in ("psm", "rm"):
            assert torch.equal(out[key], want[key]), key
        for got, exp in zip(det, want_det):
            assert torch.equal(got, exp)
    assert server.replays == len(reqs)
    with pytest.raises(ValueError, match="CUDA"):
        server({k: v.cpu() for k, v in reqs[0].items()})
