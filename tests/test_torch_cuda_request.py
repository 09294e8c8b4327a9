"""The bfloat16 server's request on the card: ``serving.batch_to_device``
casts the float32 arrays outside the geometry on the host, into reused
pinned buffers, and sends bfloat16.  On requests of the benchmark's
``mixed_serve`` and ``camera_serve`` traffic (its generator with 512^2
images and fewer point slots): every tensor equals the former path's
(the float32 array across, then the card's cast) bit for bit; requests
sent back to back behind a busy stream, without a synchronize, keep their
own bits; and the cells' ``CompiledServer`` gives the same psm, rm and
kept boxes on either.  These need an NVIDIA GPU and skip elsewhere; run
them on the card's machine without the suite's conftest:
``python -m pytest tests/test_torch_cuda_request.py -q -m gpu --noconftest``."""
import numpy as np
import pytest
import torch

from benchmark import generator, manifest
from benchmark.serve import Server
from hmvit_tpu_torch import serving

pytestmark = pytest.mark.gpu

CELLS = ("hmvit_planar.mixed_serve", "hmvit_planar.camera_serve")
SEED = 2_718_281_828
# device cycles the stream sleeps before the requests are sent (about
# 0.1 s): their copies are still queued when the host casts the next
BUSY_CYCLES = 200_000_000


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (pinned memory and the card's cast)")
    return torch.device("cuda", 0)


def cell(name: str) -> dict:
    """The cell's configuration and traffic, its pool 2 requests of 4096
    point slots."""
    spec = manifest.cell(name)
    spec["traffic"] = dict(spec["traffic"], pool=2, max_points=4096)
    return spec


def former(batch, dev):
    """The request as the bfloat16 server sent it before: every array
    across as it is, the cast on the card."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.asarray(v)).to(dev)
        if t.dtype == torch.float32 and k not in serving.GEOMETRY_KEYS:
            t = t.to(torch.bfloat16)
        out[k] = t
    return out


def assert_same_bits(got: dict, want: dict):
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if g.dtype == torch.bfloat16:
            g, w = g.view(torch.int16), w.view(torch.int16)
        assert torch.equal(g, w), k


@pytest.mark.parametrize("name", CELLS)
def test_request_equals_the_cards_cast(name, dev):
    pool = generator.make_pool(SEED, cell(name)["traffic"])
    for batch in pool:
        got = serving.batch_to_device(batch, dev, True)
        assert got["camera"].dtype == torch.bfloat16
        assert got["points"].dtype == torch.float32
        assert_same_bits(got, former(batch, dev))


@pytest.mark.parametrize("name", CELLS)
def test_requests_back_to_back_keep_their_bits(name, dev):
    """Each pinned buffer is written again while its last copy waits
    behind the sleeping stream: the pool's event holds the host back.
    The requests keep their host-cast arrays alone: a pageable copy waits
    for the stream itself and would hide a missing wait."""
    pool = [{k: v for k, v in batch.items() if v.dtype == np.float32
             and k not in serving.GEOMETRY_KEYS}
            for batch in generator.make_pool(SEED, cell(name)["traffic"])]
    assert "camera" in pool[0] and "points" not in pool[0]
    order = [0, 1, 0, 1, 1, 0]
    serving.batch_to_device(pool[0], dev, True)  # the buffers made
    torch.cuda.synchronize()
    torch.cuda._sleep(BUSY_CYCLES)
    sent = [serving.batch_to_device(pool[i], dev, True) for i in order]
    torch.cuda.synchronize()
    for i, got in zip(order, sent):
        assert_same_bits(got, former(pool[i], dev))


@pytest.mark.parametrize("name", CELLS)
def test_compiled_server_outputs_unchanged(name, dev):
    spec = cell(name)
    srv = Server(spec["config"], spec["traffic"], SEED, dev)
    for batch in srv.pool:
        out, (det,) = srv.server(former(batch, dev), srv.hints)
        want = [out["psm"].clone(), out["rm"].clone()] + [
            t.clone() for t in det]
        out, (det,) = srv.server(serving.batch_to_device(batch, dev, True),
                                 srv.hints)
        got = [out["psm"], out["rm"], *det]
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    del srv
    torch.cuda.empty_cache()
