"""The segmentation assemblies and the lidar zoo on the card: each
assembly of ``chip_smoke.SEG_LIDAR_ASSEMBLIES`` (CameraSegmentor with
CVT, FAX, VPN and BEVSwap; ``task: seg`` with F-Cooper and SwapFusion;
VoxelNet, SECOND and PIXOR alone and cooperative) in float32 with TF32
off, against the same weights' CPU forward within
``chip_smoke.SEG_LIDAR_ATOL`` of scale, with no kernel of ``csrc/``
launched.  It needs an NVIDIA GPU and skips elsewhere; the card's
machine has no JAX, so run it there without the suite's conftest:
``python -m pytest tests/test_torch_cuda_seg_lidar.py -q -m gpu
--noconftest``.
"""
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the card's forward against the "
                    "CPU's)")
    return torch.device("cuda", 0)


def test_seg_and_lidar_zoo_assemblies_on_the_card(dev):
    import chip_smoke

    total = dict.fromkeys(chip_smoke.KERNEL_META, 0)
    chip_smoke.seg_lidar_forwards(dev, torch.cuda.get_device_name(0), total)
    assert not any(total.values()), total
