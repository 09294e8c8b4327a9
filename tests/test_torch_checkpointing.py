"""Checkpoints of the port's train state (``train/checkpointing.py``, the
counterpart of ``hmvit_tpu/train/checkpointing.py`` without orbax): a
save / restore round trip gives the same params, running statistics,
optimizer state and step, and the restored state trains on exactly as
the saved one does; ``find_last_step`` finds the largest complete step
directory; ``graft_subtree`` copies one top-level submodule's entries
from a donor state dict and raises on a prefix missing from either."""
import copy
import os

import pytest
import torch

from hmvit_tpu_torch.models.hmvit import HMViT
from hmvit_tpu_torch.nn import init_parameters
from hmvit_tpu_torch.postprocess import AnchorPostprocessor
from hmvit_tpu_torch.train.checkpointing import (
    STATE_FILE,
    find_last_step,
    graft_subtree,
    restore_checkpoint,
    save_checkpoint,
)
from hmvit_tpu_torch.train.trainer import (
    create_train_state,
    labels_for_batch,
    make_train_step,
)
from tiny_cfg import POSTPROCESS_CFG
from torch_parity import t, tiny_batch, tiny_flagship_cfg


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(seed=0):
    model = init_parameters(HMViT(tiny_flagship_cfg()), seed=seed)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=1e-2)
    return create_train_state(model, opt)


def _batch():
    batch, _ = tiny_batch(2)
    pp = AnchorPostprocessor(POSTPROCESS_CFG)
    return ({k: t(v) for k, v in batch.items()},
            labels_for_batch(pp, pp.generate_anchor_box(), batch))


def test_save_restore_round_trip(tmp_path):
    batch, labels = _batch()
    state = _state()
    step = make_train_step(state.model, state.opt)
    state, _ = step(state, batch, labels)
    path = save_checkpoint(str(tmp_path), state.step, state)
    assert os.path.isfile(os.path.join(path, STATE_FILE))
    assert find_last_step(str(tmp_path)) == 1

    fresh = _state(seed=1)
    assert restore_checkpoint(str(tmp_path), fresh) is fresh
    assert fresh.step == 1
    for (name, a), b in zip(state.model.state_dict().items(),
                            fresh.model.state_dict().values()):
        assert torch.equal(a, b), name
    saved_opt, restored_opt = state.opt.state_dict(), fresh.opt.state_dict()
    assert saved_opt["param_groups"] == restored_opt["param_groups"]
    for key, entry in saved_opt["state"].items():
        for field, value in entry.items():
            assert torch.equal(torch.as_tensor(value),
                               torch.as_tensor(
                                   restored_opt["state"][key][field]))
    # the restored state trains on as the saved one does
    twin = copy.deepcopy(state)
    _, want = make_train_step(twin.model, twin.opt)(twin, batch, labels)
    _, got = make_train_step(fresh.model, fresh.opt)(fresh, batch, labels)
    assert torch.equal(got["total_loss"], want["total_loss"])
    for a, b in zip(twin.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_restore_picks_the_last_step_or_the_given_one(tmp_path):
    state = _state()
    assert restore_checkpoint(str(tmp_path), state) is None
    for n in (3, 12):
        state.step = n
        save_checkpoint(str(tmp_path), n, state)
    assert restore_checkpoint(str(tmp_path), _state()).step == 12
    assert restore_checkpoint(str(tmp_path), _state(), step=3).step == 3


def test_find_last_step(tmp_path):
    assert find_last_step(str(tmp_path / "absent")) is None
    assert find_last_step(str(tmp_path)) is None
    for name in ("2", "10", "7"):
        (tmp_path / name).mkdir()
        (tmp_path / name / STATE_FILE).write_bytes(b"")
    (tmp_path / "99").mkdir()             # no state file: incomplete
    (tmp_path / "best").mkdir()           # not a step
    (tmp_path / "11.tmp").mkdir()
    assert find_last_step(str(tmp_path)) == 10


def test_graft_subtree():
    target = _state(seed=0).model.state_dict()
    donor = _state(seed=1).model.state_dict()
    out = graft_subtree(target, donor, "camera_encoder")
    assert out.keys() == target.keys()
    for name, tensor in out.items():
        src = donor if name.startswith("camera_encoder.") else target
        assert torch.equal(tensor, src[name]), name
    # a copy: the donor's tensors are not shared, the target is untouched
    key = "camera_encoder.bev_embedding"
    assert out[key].data_ptr() != donor[key].data_ptr()
    assert not torch.equal(target[key], donor[key])
    with pytest.raises(KeyError, match="missing"):
        graft_subtree(target, donor, "no_such_module")
    with pytest.raises(KeyError, match="missing"):
        graft_subtree(target, {k: v for k, v in donor.items()
                               if not k.startswith("fusion.")}, "fusion")
