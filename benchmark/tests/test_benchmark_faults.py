"""Runs of the cells with the timed path broken underneath, at tiny sizes
on the CPU: the check must come out false for each fault a cell can have,
under the cell's own limits.

The program is made exact first, so that a sound tiny run reads far under
the limits: its augmentation is the reference's float32 chain (the port's
rounds its output to bf16, which a tiny, badly conditioned model magnifies)
and the mixup weights are 0 and 1 (which blend exactly in bf16). What is
left to tell the runs apart is the fault."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import compare, control
from benchmark.kinds import resident
from benchmark.reference import model as M, train as R

ROOT = Path(__file__).resolve().parents[2]


def _limits(cell):
    return json.loads((ROOT / "benchmark" / "cells" / f"{cell}.json").read_text())["limits"]


@pytest.fixture
def exact_training(monkeypatch):
    import tdeed_tpu_torch.train.step as step

    monkeypatch.setattr(step, "train_preprocess",
                        lambda f, a: R.photometric(f, a.float()).to(torch.float32))
    draw = R.draw

    def exact_draw(*args, **kw):
        d = draw(*args, **kw)
        if d.lam is not None:
            d.lam = (torch.arange(len(d.lam)) % 2).float()
        return d

    monkeypatch.setattr(resident.R, "draw", exact_draw)
    torch.set_num_threads(2)


def _training_cell(name):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())
    cfg.update(clip_len=8, batch_size=4, dtype="float32",
               frame_hw=[72, 80] if cfg.get("crop_dim", -1) > 0 else [48, 64])
    if cfg.get("crop_dim", -1) > 0:
        cfg["crop_dim"] = 64
    return resident.Cell(cfg, {"kind": "resident", "batches": 3, "event_share": 0.1}, 5,
                         device="cpu")


CELLS = ["FineDiving_small.train_step", "SoccerNetBall_challenge1.train_step"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_tiny_training_run_is_correct(exact_training, cell):
    run = _training_cell(cell.split(".")[0])
    run.window(0.5)
    numbers = run.check()
    assert compare.judge(numbers, _limits(cell)), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_leaves_the_state_unchanged_is_not_correct(exact_training, monkeypatch, cell):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)
    run = _training_cell(cell.split(".")[0])
    numbers = run.check()
    assert numbers["change_gap_worst"] == pytest.approx(1.0)
    assert not compare.judge(numbers, _limits(cell)), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_over_half_the_batch_is_not_correct(exact_training, cell):
    undo = control.half_batch()
    try:
        run = _training_cell(cell.split(".")[0])
    finally:
        undo()
    numbers = run.check()
    assert not compare.judge(numbers, _limits(cell)), numbers


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_in_the_programs_place_is_not_correct(exact_training, cell):
    """The reference in float8 (benchmark/control.py's control), judged as
    the program is."""
    run = _training_cell(cell.split(".")[0])
    run.free()
    numbers = compare.training_gaps(run.reference(quant=M.fp8), run.reference())
    assert not compare.judge(numbers, _limits(cell)), numbers


def test_the_control_reads_the_reference_in_fp8():
    x = torch.linspace(-3, 3, 1001)
    q = M.fp8(x)
    # e4m3 keeps 3 bits of mantissa: a relative step of 1/8 at most
    assert (q - x).abs().max() <= x.abs().max() / 16
    assert not torch.equal(q, x)
