"""One train step on the card at the rehearsal widths
(``hmvit_tpu_torch.perf_lab.rehearsal_cfg``, float32, remat over every
stage): the CUDA kernels against their plain twins (``plain_ops()``)
from the same weights, the loss within 2e-3 relative and every
parameter's gradient within 2e-3 of its largest |value| (the scale of
``chip_smoke.py``'s forward check); and the pair warp, stripe and plain
attention kernels launched in the step as many times as a train-mode
forward of the same model launches them, times one plus the remat
recompute (every kernel lies in a stage that remat covers).  These need
an NVIDIA GPU and nvcc and skip elsewhere; the card's machine has no
JAX, so run them there without the suite's conftest:
``python -m pytest tests/test_torch_cuda_train.py -q -m gpu --noconftest``.
"""
import copy

import pytest
import torch

from hmvit_tpu_torch.data.anchors import generate_anchor_grid
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.ops import cuda, plain_ops
from hmvit_tpu_torch.perf_lab import rehearsal_cfg
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.serving import anchor_args, batch_to_device, \
    request_batch
from hmvit_tpu_torch.train.trainer import (
    create_train_state,
    labels_for_batch,
    make_train_step,
)
from hmvit_tpu_torch.utils.precision import strict_fp32

pytestmark = pytest.mark.gpu

TOL = 2e-3


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels run only on the card)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("remat", [True, False])
def test_train_step_kernels_vs_plain(dev, remat):
    cfg = dict(rehearsal_cfg(), remat=remat)
    batch = request_batch(0, max_points=512, image_size=64, num_cams=2,
                          lidar_range=cfg["lidar"]["lidar_range"])
    pp = AnchorPostprocessor({"anchor_args": anchor_args(cfg),
                              "target_args": {"pos_threshold": 0.6,
                                              "neg_threshold": 0.45},
                              "order": "hwl"})
    labels = labels_for_batch(pp, generate_anchor_grid(anchor_args(cfg)),
                              batch, dev)
    tb = batch_to_device(batch, dev, bf16=False)
    model = init_parameters(HMViT(cfg), seed=0).to(dev)
    # the forward's launches: train mode (run-both batch statistics,
    # remat's routing), no autograd, so no recompute
    fwd = copy.deepcopy(model).train()
    cuda.reset_launches()
    with torch.no_grad(), strict_fp32():
        fwd(tb)
    forward = cuda.launch_counts()
    del fwd
    kernels = ("pair_warp", "stripe_window_attention",
               "plain_window_attention")
    assert all(forward[k] > 0 for k in kernels), forward
    runs = {}
    for name in ("kernels", "plain"):
        m = copy.deepcopy(model)
        opt = torch.optim.SGD(m.parameters(), lr=0.0)
        step = make_train_step(m, opt)
        cuda.reset_launches()
        with strict_fp32():
            if name == "plain":
                with plain_ops():
                    _, parts = step(create_train_state(m, opt), tb, labels)
            else:
                _, parts = step(create_train_state(m, opt), tb, labels)
        torch.cuda.synchronize()
        runs[name] = (float(parts["total_loss"]), cuda.launch_counts(),
                      {n: p.grad for n, p in m.named_parameters()})
    counts = runs["kernels"][1]
    assert counts == {k: n * (2 if remat else 1)
                      for k, n in forward.items()}, (counts, forward)
    assert all(n == 0 for n in runs["plain"][1].values())
    loss_k, loss_p = runs["kernels"][0], runs["plain"][0]
    assert abs(loss_k - loss_p) <= TOL * abs(loss_p)
    for name, g in runs["kernels"][2].items():
        ref = runs["plain"][2][name]
        scale = max(float(ref.abs().max()), 1e-12)
        assert float((g - ref).abs().max()) <= TOL * scale, name
