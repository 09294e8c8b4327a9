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


@pytest.mark.parametrize("static", [True, False])
def test_bf16_kv_contraction_accumulates_in_float32(dev, static):
    """The typed [K|V] contraction of a bf16 fusion block on the card: the
    bf16 operands enter the GEMM as they are and come out in float32
    (``utils.precision.dot_f32``), in both branches (the
    static-modes parameter fold and the per-sender relation product).
    The float32 path on the CPU rounds its float32 result to bf16 too, so
    the two lie within one bf16 ulp (2^-7 relative) of each other.  The
    gradients through the contraction agree with float32 autograd."""
    from hmvit_tpu_torch.models.hetero_fusion import HeteroWindowAttention
    from hmvit_tpu_torch.nn import init_parameters
    from hmvit_tpu_torch.utils.precision import dot_f32

    a = torch.randn(3, 40, 32, device=dev).bfloat16().requires_grad_()
    b = torch.randn(3, 32, 24, device=dev).bfloat16().requires_grad_()
    got = dot_f32(a, b)
    assert got.dtype == torch.float32
    with strict_fp32():
        ref = torch.bmm(a.detach().float(), b.detach().float())
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    g = torch.randn_like(got)
    ga, gb = torch.autograd.grad(got, (a, b), g)
    with strict_fp32():
        a32 = a.detach().float().requires_grad_()
        b32 = b.detach().float().requires_grad_()
        ra, rb = torch.autograd.grad(torch.bmm(a32, b32), (a32, b32), g)
    assert ga.dtype == a.dtype and gb.dtype == b.dtype
    assert float((ga.float() - ra).abs().max()) <= \
        2 ** -7 * float(ra.abs().max())
    assert float((gb.float() - rb).abs().max()) <= \
        2 ** -7 * float(rb.abs().max())

    attn = init_parameters(HeteroWindowAttention(
        64, dim_head=16, compute_dtype="bfloat16"), seed=0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 8, 8, 64, generator=gen).bfloat16()
    mode = torch.tensor([[1, 0, 1], [0, 1, 1]])
    static_modes = (1, 0, 1) if static else None
    if static:
        x, mode = x[:1], mode[:1]
    want = attn._typed_kv(x, mode, static_modes, (0, 1))  # CPU: float32
    attn_dev = attn.to(dev)
    with strict_fp32():
        got = attn_dev._typed_kv(x.to(dev), mode.to(dev), static_modes,
                                 (0, 1))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    ref = want.float().to(dev)
    bound = 2 ** -7 * ref.abs() + 1e-5 * float(ref.abs().max())
    assert bool(((got.float() - ref).abs() <= bound).all())
