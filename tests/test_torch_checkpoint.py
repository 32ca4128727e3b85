"""The port's checkpoints (tdeed_tpu_torch/checkpoint.py) and step-level
resume, on the CPU at a small size (full rny002 widths, clip 8, 24x24
frames cropped to 16, fp32, mixup on).

Resume is exact: 4 optimizer steps straight through give the same
parameter, buffer and optimizer bits as 2 steps, a save, a fresh model,
optimizer and schedule (other weights), a restore and 2 more steps,
whether the save was ``save_epoch`` or the interrupt save (``save_state``
alone, no meta). The step's draws depend on (seed, step) only, so nothing
else needs saving."""

import json
import os

import numpy as np
import pytest
import torch

from tdeed_tpu_torch import checkpoint as ckpt_mod
from tdeed_tpu_torch.checkpoint import BEST, LAST, META, CheckpointManager, save_state
from tdeed_tpu_torch.config import TDEEDConfig
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import make_train_step

CFG = TDEEDConfig(clip_len=8, crop_dim=16, n_layers=1, sgp_ks=3, sgp_r=2,
                  radi_displacement=1, dtype="float32")
STEPS = 4


def _batches():
    rng = np.random.default_rng(2)

    def one():
        return {
            "frame": rng.integers(0, 256, (2, 8, 24, 24, 3), dtype=np.uint8),
            "label": rng.integers(0, 5, (2, 8)).astype(np.int32),
            "labelD": rng.integers(-1, 2, (2, 8)).astype(np.float32),
            "frame2": rng.integers(0, 256, (2, 8, 24, 24, 3), dtype=np.uint8),
            "label2": rng.integers(0, 5, (2, 8)).astype(np.int32),
            "labelD2": rng.integers(-1, 2, (2, 8)).astype(np.float32),
        }

    return [one() for _ in range(STEPS)]


def _trainer(weight_seed):
    torch.manual_seed(weight_seed)
    model = build_model(CFG, device="cpu")
    opt, sched = make_optimizer(model.parameters(), 1e-3, 2, 6)
    return make_train_step(model, opt, sched, crop_dim=16, num_classes_bg=5, mixup=True,
                           radi_displacement=1, seed=7)


def _bits(step):
    sd = step.state_dict()
    flat = dict(sd["model"])
    for i, s in sd["optimizer"]["state"].items():
        flat.update({f"opt.{i}.{k}": v for k, v in s.items()})
    return flat, sd["scheduler"]["last_epoch"], sd["step"]


@pytest.fixture(scope="module")
def straight():
    step = _trainer(0)
    losses = [float(step(b)["loss"]) for b in _batches()]
    assert all(np.isfinite(losses))
    return _bits(step)


@pytest.mark.parametrize("save", ["save_epoch", "interrupt"])
def test_resume_gives_the_uninterrupted_bits(straight, tmp_path, save):
    batches = _batches()
    step = _trainer(0)
    for b in batches[:2]:
        step(b)
    mgr = CheckpointManager(str(tmp_path))
    if save == "save_epoch":
        mgr.save_epoch(step, 0, {"epoch": 0}, True, 1.0)
    else:
        save_state(os.path.join(str(tmp_path), LAST), step)

    fresh = _trainer(1)  # other weights: the restore must overwrite them all
    restored, next_epoch = CheckpointManager(str(tmp_path)).restore_last(fresh)
    assert restored is fresh and fresh.step == 2
    assert next_epoch == (1 if save == "save_epoch" else 0)
    for b in batches[2:]:
        fresh(b)
    got, want = _bits(fresh), straight
    assert got[1:] == want[1:] == (STEPS, STEPS)
    assert sorted(got[0]) == sorted(want[0])
    for k, v in want[0].items():
        assert torch.equal(got[0][k], v), k


def test_restore_last_without_a_checkpoint_returns_the_template(tmp_path):
    step = _trainer(0)
    got, epoch = CheckpointManager(str(tmp_path / "run")).restore_last(step)
    assert got is step and epoch == 0 and step.step == 0


def test_a_failed_write_leaves_the_previous_checkpoint(tmp_path, monkeypatch):
    step = _trainer(0)
    step(_batches()[0])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_epoch(step, 0, {"epoch": 0}, True, 1.0)
    files = {n: (tmp_path / n).read_bytes() for n in (BEST, LAST, META, "loss.json")}

    def dying_save(obj, path):
        with open(path, "wb") as fp:
            fp.write(b"half a checkpoint")
        raise OSError("disk full")

    step(_batches()[1])
    monkeypatch.setattr(ckpt_mod.torch, "save", dying_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save_epoch(step, 1, {"epoch": 1}, True, 0.5)
    with pytest.raises(OSError, match="disk full"):
        save_state(os.path.join(str(tmp_path), LAST), step)
    monkeypatch.undo()
    for name, data in files.items():
        assert (tmp_path / name).read_bytes() == data, name
    fresh = _trainer(1)
    _, epoch = mgr.restore_last(fresh)
    assert epoch == 1 and fresh.step == 1


def test_best_and_meta_follow_the_reference_layout(tmp_path):
    """checkpoint_best is the model's state_dict under its own names
    (load_state_dict(strict=True) takes it); train_meta.json and loss.json
    carry the history."""
    step = _trainer(0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_epoch(step, 0, {"epoch": 0, "train": 2.0}, True, 2.0)
    mgr.save_epoch(step, 1, {"epoch": 1, "train": 1.0}, False, 2.0)
    best = mgr.restore_best()
    assert sorted(best) == sorted(step.model.state_dict())
    assert all(v.device.type == "cpu" for v in best.values())
    torch.manual_seed(5)
    build_model(CFG, device="cpu").load_state_dict(best, strict=True)
    meta = json.loads((tmp_path / META).read_text())
    assert meta == mgr.load_meta()
    assert meta["epoch"] == 1 and meta["best_criterion"] == 2.0
    assert json.loads((tmp_path / "loss.json").read_text()) == meta["history"] == [
        {"epoch": 0, "train": 2.0}, {"epoch": 1, "train": 1.0}]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
