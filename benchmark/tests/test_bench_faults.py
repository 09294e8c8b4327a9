"""A run at CPU widths with the timed path broken underneath (the card's
look skipped, the graph server eager): ``correct`` comes out false for
each fault the cells can have.  A serve cell's answer altered where it
is produced (the scores, or the boxes); a train cell's step that leaves
its state unchanged, and its loss altered.  (Batch 1 and one card: no
half-batch or exchange fault.)"""
import pytest
import torch

from benchmark import run, serve, train
from benchmark.tests.rehearsal import EagerServer, cpu_spec, on_cpu


def drive(spec, monkeypatch, runner):
    with on_cpu(monkeypatch) as dev:
        out = runner.run(spec, 2 ** 31 + 3, 1.0, False, 0.0, dev)
    return run.judge(out["compared"], spec["limits"])


def test_a_sound_serve_run_is_correct(monkeypatch):
    correct, table = drive(cpu_spec("hmvit_planar.mixed_serve"),
                           monkeypatch, serve)
    assert correct, table


@pytest.mark.parametrize("fault", ["scores", "boxes"])
def test_an_altered_answer_is_not_correct(monkeypatch, fault):
    class Broken(EagerServer):
        def __call__(self, request, hints):
            out, det = super().__call__(request, hints)
            if fault == "scores":
                out = dict(out, psm=out["psm"] + 2.0)
            else:
                (c, s, v), = det
                det = [(c + 0.5, s, v)]
            return out, det

    import hmvit_tpu_torch.graph_server as gs

    spec = cpu_spec("hmvit_planar.mixed_serve")
    with on_cpu(monkeypatch) as dev:
        monkeypatch.setattr(gs, "CompiledServer", Broken)
        out = serve.run(spec, 2 ** 31 + 3, 1.0, False, 0.0, dev)
    correct, table = run.judge(out["compared"], spec["limits"])
    assert not correct, table


@pytest.mark.parametrize("fault", ["unchanged", "loss"])
def test_a_broken_train_step_is_not_correct(monkeypatch, fault):
    import hmvit_tpu_torch.train.trainer as trainer

    made = trainer.make_train_step

    def make(model, opt, **kwargs):
        step = made(model, opt, **kwargs)

        def broken(state, batch, labels, seed=0):
            if fault == "unchanged":
                with torch.no_grad():
                    out = model(batch)
                    loss = out["psm"].float().mean()
                # the optimizer's first moment as a step would leave it
                for p in model.parameters():
                    opt.state[p]["exp_avg"] = torch.zeros_like(p)
                return state, {"total_loss": loss}
            state, parts = step(state, batch, labels, seed)
            return state, dict(parts, total_loss=parts["total_loss"] * 1.5)
        return broken

    monkeypatch.setattr(trainer, "make_train_step", make)
    spec = cpu_spec("hmvit_planar.mixed_train")
    correct, table = drive(spec, monkeypatch, train)
    assert not correct, table
