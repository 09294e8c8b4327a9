"""The reference against the port on the CPU at tiny widths, with the
benchmark's seeded weights: the serving forward and decode + NMS, and
three float32 training steps (the reference's AdamW written out)."""
import pytest
import torch

from benchmark import compare, generator, train, weights
from benchmark.tests.rehearsal import cpu_spec


@pytest.fixture(scope="module",
                params=["hmvit_planar.mixed_serve",
                        "hmvit_bevformer_ref.mixed_serve"])
def spec(request):
    return cpu_spec(request.param)


def test_serving_forward_and_decode_equal_the_port(spec):
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.postprocess import decode_detections_device

    config, traffic = spec["config"], spec["traffic"]
    cfg = compare.reference_config(config["model"])
    port = HMViT(cfg)
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
            assert compare.output_gaps(got["psm"], got["rm"], want) == \
                (0.0, 0.0)
    anchors = torch.as_tensor(
        compare.generate_anchor_grid(config["anchor_args"], "hwl"),
        dtype=torch.float32)
    a = decode_detections_device(got["psm"], got["rm"], anchors, torch.eye(4))
    b = compare.decode_detections_device(got["psm"], got["rm"], anchors,
                                         torch.eye(4))
    assert compare.box_gap(compare.kept_boxes(*a),
                           compare.kept_boxes(*b)) == 0.0


def test_training_steps_equal_the_port():
    from hmvit_tpu_torch.models.hmvit import HMViT
    from hmvit_tpu_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )

    spec = cpu_spec("hmvit_planar.mixed_train")
    config, traffic = spec["config"], spec["traffic"]
    config["train"]["half"] = False
    tcfg, o = config["train"], config["train"]["optimizer"]
    model = HMViT(dict(compare.reference_config(config["model"]),
                       remat=tcfg["remat"]))
    weights.load(model, weights.make_weights(weights.float_shapes(model), 4,
                                             "cpu", torch.float32))
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = torch.optim.AdamW(model.parameters(), lr=o["lr"],
                            betas=tuple(o["betas"]), eps=o["eps"],
                            weight_decay=o["weight_decay"])
    step = make_train_step(model, opt, loss_kwargs=tcfg["loss"])
    state = create_train_state(model, opt)
    pool = generator.make_pool(4, traffic)
    labs = train.labels(pool, config, "cpu")
    first = {}

    def keep_first(m, args, out):
        if not first:
            first.update({k: v.detach().float().clone()
                          for k, v in out.items()})

    model.register_forward_hook(keep_first)
    losses = []
    for k in range(3):
        _, parts = step(state, compare.to_device(pool[k], "cpu"), labs[k], 4)
        losses.append(float(parts["total_loss"]))
        if k == 0:
            grads = train.norms({n: opt.state[p]["exp_avg"] / 0.1
                                 for n, p in model.named_parameters()})
    change = train.norms({n: p.detach() - start[n]
                          for n, p in model.named_parameters()})
    gaps, _ = compare.train_numbers(
        {"losses": losses, "grads": grads, "change": change,
         "outputs": first}, pool, labs,
        config, 4, "cpu", 3)
    # float32 both sides, the same operations in another order: the
    # first step's outputs, loss and gradient agree to rounding; under
    # AdamW (eps 1e-10) an element whose gradient is rounding noise moves
    # a whole step of either sign, so the change's norms agree to 1e-2
    assert gaps["psm_mean_gap"] < 1e-5 and gaps["rm_l2_gap"] < 1e-5
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-5
    assert gaps["update_gap"] < 1e-2


def test_the_control_rounds_forward_and_backward_to_float8():
    """The control's rounding: e4m3 forward, the incoming gradient e5m2
    backward, each under one scale that maps the largest magnitude to
    the type's largest."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(4096, generator=gen).requires_grad_()
    g = torch.randn(4096, generator=gen)
    y = compare._fp8(x)
    y.backward(g)

    def rounded(t, dtype, top):
        scale = t.abs().max() / top
        return (t / scale).to(dtype).float() * scale

    torch.testing.assert_close(y.detach(), rounded(x.detach(),
                               torch.float8_e4m3fn, 448.0), rtol=0, atol=0)
    torch.testing.assert_close(x.grad, rounded(g, torch.float8_e5m2,
                                               57344.0), rtol=0, atol=0)
    assert not torch.equal(x.grad, g)
