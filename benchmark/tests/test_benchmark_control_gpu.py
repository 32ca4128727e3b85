"""The control and the faults at the cells' own sizes, on the card:
``benchmark.control`` on one seed a cell, judged by the cell's limits.
The program reads correct; the float8 control and each fault do not.

    python -m pytest benchmark/tests/test_benchmark_control_gpu.py -m gpu -q
"""

import importlib

import pytest

from benchmark import compare, control
from benchmark.run import plan


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["FineDiving_small.train_step",
                                  "SoccerNetBall_challenge1.train_step"])
def test_training_control_and_half_batch_are_not_correct(card, cell):
    _, cfg_file, mix, limits, _, _ = plan(cell)
    kind = importlib.import_module(f"benchmark.kinds.{mix['kind']}")
    rows = dict(control.training(kind, cfg_file, mix, 2147483901, with_control=True))
    assert compare.judge(rows["program"], limits), rows["program"]
    assert not compare.judge(rows["control"], limits), rows["control"]
    assert not compare.judge(rows["half"], limits), rows["half"]

