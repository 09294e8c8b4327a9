"""The reference twins and the checkpoint converter on the card: HMViT
with each twin (``chip_smoke.ZOO_TWINS``) in float32, the kernels
against ``plain_ops()``, the launches a served frame's, the captured
graph equal to the eager forward and the card's plain forward within
``chip_smoke.SEG_LIDAR_ATOL`` of the CPU's; a smoke-width flagship with
``bevformer_ref`` converted from a reference-named file by the CLI and
held card against CPU; the standalone ``RefBEVFormerDetector``
converted and served.  It needs an NVIDIA GPU and nvcc and skips
elsewhere; the card's machine has no JAX, so run it there without the
suite's conftest: ``python -m pytest
tests/test_torch_cuda_reference_twins.py -q -m gpu --noconftest``.
"""
import os

import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the twins' forwards on the card, "
                    "the kernels built by nvcc)")
    from hmvit_tpu_torch.ops import cuda

    cuda.load_library()
    return torch.device("cuda", 0)


def test_hmvit_twins_on_the_card(dev):
    import chip_smoke

    total = dict.fromkeys(chip_smoke.KERNEL_META, 0)
    chip_smoke.zoo_forwards(dev, torch.cuda.get_device_name(0), total,
                            names=chip_smoke.ZOO_TWINS)
    # the smoke fusion's launches only (one H3GAT iteration: 2 warps, a
    # stripe and a grid-phase attention a forward); no twin launches one
    n = len(chip_smoke.ZOO_TWINS)
    assert (total["pair_warp"], total["stripe_window_attention"],
            total["plain_window_attention"]) == (2 * n, n, n)


def test_converted_flagship_card_vs_cpu(dev, tmp_path):
    """A smoke-width flagship with ``bevformer_ref``: the port's export of
    a seeded model -> the convert CLI (bit for bit) -> card vs CPU."""
    import chip_smoke
    from hmvit_tpu_torch.config import load_config

    params = load_config(os.path.join(chip_smoke.HYPES,
                                      "smoke_hetero_tiny.yaml"))
    params["model"]["core_method"] = chip_smoke.TWIN_CORE
    params["model"]["args"]["camera"] = dict(chip_smoke.TWIN_WRAPPER_CAMERA)
    _, run, _, _ = chip_smoke.convert_seeded_flagship(params, str(tmp_path))
    chip_smoke.twin_card_vs_cpu(run, params, dev,
                                torch.cuda.get_device_name(0))


def test_converted_wrapper_served(dev, tmp_path):
    import chip_smoke

    total = dict.fromkeys(chip_smoke.KERNEL_META, 0)
    chip_smoke.twin_wrapper(dev, torch.cuda.get_device_name(0),
                            str(tmp_path), total)
    assert not any(total.values())
