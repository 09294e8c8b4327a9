"""The port's benchmark entry, ``python -m hmvit_tpu_torch.bench``: its
CPU rehearsal prints one JSON line with ``bench.py``'s keys and says its
time is no device time; without CUDA and without ``--cpu`` it exits 2;
``--stem_s2d --cpu`` serves the space-to-depth stem, whose outputs are
the plain stem's; ``--train --cpu`` rehearses the training bench and prints
``bench.py``'s training keys.  At tiny widths the batch-2 serving forward, with the
hints ``bench --batch 2`` gives, equals two batch-1 forwards and the JAX
package's batch-2 forward; ``flops_per_frame`` is the FLOP counter's
count plus the hand-written kernels' operation counts, each wrapper
recorded once a call."""
import argparse
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from hmvit_tpu.models.hmvit import HMViT as JHMViT
from hmvit_tpu_torch import bench
from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.ops.opcount import record_kernel_ops
from hmvit_tpu_torch.serving import request_batch, serving_hints
from tiny_cfg import RANGE
from torch_parity import bridged, close, flax_variables, japply, t, \
    tiny_flagship_cfg

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "flops_per_frame",
              "flops_unit", "mfu", "device_kind", "ms_per_frame"}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def cpu_args(**kw):
    args = dict(fp32=False, cpu=True, fused_wa=False, no_stripe=False,
                expand=None, batch=1, iters=1, train=False, stem_s2d=False)
    args.update(kw)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("flags", [[], ["--batch", "2", "--fp32"],
                                   ["--fused_wa", "--expand", "v2"],
                                   ["--no_stripe", "--expand", "v1"]])
def test_cpu_rehearsal_prints_one_record(flags, capsys):
    assert bench.main(["--cpu", "--iters", "1", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert BENCH_KEYS <= set(record)
    assert record["metric"].startswith(bench.METRIC)
    assert ("serving batch 2" in record["metric"]) == ("--batch" in flags)
    assert record["unit"] == "frames/sec/chip"
    assert record["value"] > 0 and record["flops_per_frame"] > 0
    assert record["vs_baseline"] == pytest.approx(
        record["value"] / bench.ASSUMED_REFERENCE_FPS, abs=1e-3)
    assert record["mfu"] is None and record["device_kind"] == "cpu"
    assert record["note"] == bench.CPU_NOTE
    assert "not a device time" in record["note"]


def test_refuses_to_run_without_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would run")
    assert bench.main([]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "no CUDA device" in captured.err


@pytest.mark.parametrize("flag", ["--stem_s2d"])
def test_unported_flags_are_refused(flag, capsys):
    """The flags of ``bench.py`` the port once refused are served now:
    ``bench --stem_s2d --cpu`` prints its record, and the model it serves
    (float32, the rehearsal widths) gives the plain stem's psm and rm on
    the same weights and request, within the s2d stem's own bar 2e-5
    (tests/test_resnet.py) over max(1, max |x|)."""
    assert bench.main(["--cpu", "--iters", "1", flag]) == 0
    record = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert record["value"] > 0 and record["note"] == bench.CPU_NOTE
    outs = []
    for s2d in (False, True):
        model, request, hints, _ = bench.build(
            cpu_args(fp32=True, stem_s2d=s2d), torch.device("cpu"))
        assert model.camera_encoder.ResNetEncoder_0.stem_s2d == s2d
        with torch.no_grad():
            outs.append(model(request, **hints))
    for key in ("psm", "rm"):
        plain, s2d = outs[0][key].numpy(), outs[1][key].numpy()
        scale = max(1.0, float(np.abs(plain).max()))
        np.testing.assert_allclose(s2d / scale, plain / scale, atol=2e-5)


TRAIN_KEYS = {"metric", "value", "unit", "frames_per_sec", "flops_per_step",
              "flops_unit", "train_mfu", "hbm_peak_gb", "vs_baseline",
              "device_kind"}


@pytest.mark.parametrize("flags", [[], ["--no_remat", "--bucketed"]])
def test_train_cpu_rehearsal_prints_one_record(flags, capsys):
    """``--train --cpu``: the training bench's flow (labels, AdamW, the
    half-precision step with remat, FLOP count) at the rehearsal widths;
    no device number (``train_mfu``, ``hbm_peak_gb``) on the CPU."""
    assert bench.main(["--cpu", "--train", "--iters", "1", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert TRAIN_KEYS <= set(record)
    assert record["metric"].startswith(bench.TRAIN_METRIC)
    assert ("remat=False" in record["metric"]) == ("--no_remat" in flags)
    assert ("count-bucketed" in record["metric"]) == ("--bucketed" in flags)
    assert record["unit"] == "steps/sec/chip"
    assert record["value"] > 0 and record["frames_per_sec"] > 0
    assert record["flops_per_step"] > record["kernel_gflops_per_step"] > 0
    assert record["train_mfu"] is None and record["hbm_peak_gb"] is None
    assert all(np.isfinite(record["loss_first_last"]))
    assert record["note"] == bench.CPU_NOTE


def test_peak_table():
    assert bench.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert bench.peak_bf16_flops("NVIDIA H100 PCIe") == 756e12
    assert bench.peak_bf16_flops("cpu") is None


@pytest.fixture(scope="module")
def batch2():
    """A batch of two tiny fleets (seed 0), its bench hints, and the
    port's tiny model with the JAX package's weights."""
    torch.set_num_threads(1)
    cfg = tiny_flagship_cfg()
    batch = request_batch(0, max_points=512, image_size=64, num_cams=2,
                          lidar_range=RANGE, batch_size=2)
    jm = JHMViT(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = flax_variables(jm, jb, train=False)
    return dict(cfg=cfg, batch=batch, jm=jm, jb=jb, v=v,
                model=bridged(HMViT(cfg), v).requires_grad_(False))


def test_batch2_equals_two_batch1_forwards_and_jax(batch2):
    """``bench --batch 2``'s hints count the cameras of the whole batch
    (4); the port's forward then equals its batch-1 forward of each
    fleet (1e-5, convolutions over another batch size) and the JAX
    package's batch-2 forward with the same hints but the camera bucket
    (1e-4, as tests/test_torch_hmvit.py).  JAX's bucketed branch takes a
    bucket of 4 >= the 4 agents of ONE row for an all-camera batch, so
    it is held with the run-both encoders it is documented to equal."""
    batch, model = batch2["batch"], batch2["model"]
    hints = serving_hints(batch["mode"][0], 4, batch_size=2)
    assert hints["camera_bucket"] == 4
    with torch.no_grad():
        out = model({k: t(x) for k, x in batch.items()}, **hints)
        for i in range(2):
            one = model({k: t(x[i:i + 1]) for k, x in batch.items()},
                        **serving_hints(batch["mode"][i], 4))
            for key in ("psm", "rm"):
                close(out[key][i:i + 1], one[key].numpy(), 1e-5)
    ref = japply(batch2["jm"], batch2["v"], batch2["jb"], train=False,
                 **dict(hints, camera_bucket=None))
    for key in ("psm", "rm"):
        assert tuple(out[key].shape)[0] == 2
        close(out[key], ref[key], 1e-4)


def test_flops_are_the_counter_plus_the_kernel_counts(batch2):
    """count_flops = FlopCounterMode's count with the plain twins hidden
    + the kernel formulas; each serving wrapper recorded once a call
    (batch 1 split server: pair warp x4, stripe x2, plain x2 for the
    fusion's grid phases; the camera self-attention reaches the plain
    wrapper only on CUDA tensors, and on the CPU the counter counts its
    einsums instead); the twins' own FLOPs are not in the counter's
    count."""
    batch, model = batch2["batch"], batch2["model"]
    one = {k: t(x[:1]) for k, x in batch.items()}
    hints = serving_hints(batch["mode"][0], 4)
    counted, kernel_ops = bench.count_flops(model, one, hints)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter, record_kernel_ops() as calls:
        model(one, **hints)
    assert counted == counter.get_total_flops()
    assert kernel_ops == sum(ops for _, ops in calls) > 0
    names = [name for name, _ in calls]
    assert {n: names.count(n) for n in set(names)} == {
        "pair_warp": 4, "stripe_window_attention": 2,
        "plain_window_attention": 2}
    unhidden = FlopCounterMode(display=False)
    with torch.no_grad(), unhidden:
        model(one, **hints)
    assert unhidden.get_total_flops() > counted


def test_record_flops_per_frame(monkeypatch):
    """The record's flops_per_frame is count_flops' sum over the batch
    size, in GFLOP."""
    seen = []
    real = bench.count_flops

    def spy(*a):
        seen.append(real(*a))
        return seen[-1]

    monkeypatch.setattr(bench, "count_flops", spy)
    record = bench.run(cpu_args(batch=2))
    (counted, kernel_ops), = seen
    assert record["flops_per_frame"] == round(
        (counted + kernel_ops) / 2 / 1e9, 2)
    assert np.isfinite(record["ms_per_frame"])


def test_kernel_operation_formulas():
    """The formulas chip_smoke.py's bounds and the FLOP count share: at
    the production shapes (128^2 maps, window 8, 8 heads of 32, 4
    agents) a multiply-add is 2 operations."""
    from hmvit_tpu_torch.ops.opcount import attention_ops, pair_warp_ops

    t, d, heads, windows = 64, 32, 8, 256
    qk_pv = 2 * (2 * t * t * d)  # q k^T and p v per sender window
    assert attention_ops(4, windows, t, 4, heads, d) == \
        4 * windows * heads * 4 * qk_pv
    typed = 2 * (2 * t * d * d)  # q W_att and v W_msg per sender window
    assert attention_ops(4, windows, t, 4, heads, d, typed=True) == \
        4 * windows * heads * 4 * (qk_pv + typed)
    assert pair_warp_ops(3, 4, 128, 128, 512) == 12.0 * 3 * 4 * 128 ** 2 * 512


def test_flop_counter_counts_bmm_with_out_dtype():
    """``bmm(a, b, out_dtype=float32)`` (the bf16 [K|V] contraction's
    product on the card) counts as a ``bmm``; the library's own formula
    takes the dtype for the output's shape and raises."""
    from hmvit_tpu_torch.ops.opcount import flop_counter

    a = torch.empty(3, 40, 32, device="meta", dtype=torch.bfloat16)
    b = torch.empty(3, 32, 24, device="meta", dtype=torch.bfloat16)
    counter = flop_counter()
    with counter:
        out = torch.bmm(a, b, out_dtype=torch.float32)
        torch.bmm(a, b)
    assert out.dtype == torch.float32
    assert counter.get_total_flops() == 2 * (2 * 3 * 40 * 32 * 24)
