"""The numbers that decide ``correct``: gaps between what the program
produced and what the reference works out, each read against a limit."""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence

import torch

# A tensor whose first gradient in the reference is under this share of
# the median tensor's is moved by AdamW's rounding alone (a bias ahead of
# a normalisation): its change is not compared.
TINY_GRAD = 1e-3


def loss_gaps(program: Sequence[float], reference: Sequence[float]) -> List[float]:
    """Each step's relative gap between the losses."""
    return [abs(p - r) / abs(r) for p, r in zip(program, reference)]


def leaf_gaps(program: Dict[str, float], reference: Dict[str, float],
              names: Sequence[str]) -> List[float]:
    """Each tensor's gap between its norm in the program and in the
    reference, relative to the reference's norm of that tensor or of the
    median tensor, whichever is larger: a tensor of one or two values
    (a gate's bias) can sum to nearly 0 in the reference, and its gap is
    then read against the median tensor's size."""
    floor = statistics.median(reference[n] for n in names)
    return [abs(program[n] - reference[n]) / max(reference[n], floor) for n in names]


def output_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The norm of the outputs' difference relative to the reference's
    norm, over every element; rows the program did not produce count as
    zeros."""
    got = torch.zeros_like(reference, dtype=torch.float64)
    got[:program.shape[0]] = program[:reference.shape[0]].double()
    return float(torch.linalg.vector_norm(got - reference.double())
                 / torch.linalg.vector_norm(reference.double()))


def moved(grad_norms: Dict[str, float]) -> list:
    """The tensors whose change is compared: those with a first gradient of
    at least TINY_GRAD of the median tensor's in the reference."""
    med = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= TINY_GRAD * med]


def training_gaps(program: dict, reference: dict) -> Dict[str, float]:
    """The gaps of two readings, each {"losses": [...], "grad": {name:
    norm}, "change": {name: norm}, "outputs": (logits, displacements)}:
      logit_gap        the first step's logits, by ``output_gap``;
                       displ_gap its displacements'
      loss_gap         the first step's relative gap of the losses;
                       loss_gap_mean the mean of the three steps'
      grad_gap_worst   the widest tensor's gap of the first gradient's
                       norm, by ``leaf_gaps``; grad_gap the median tensor's
      change_gap_worst the widest gap of the change's norm over the
                       tensors ``moved`` names; change_gap the median's
    Each cell's limits name the numbers it compares."""
    grad = leaf_gaps(program["grad"], reference["grad"], list(reference["grad"]))
    change = leaf_gaps(program["change"], reference["change"], moved(reference["grad"]))
    losses = loss_gaps(program["losses"], reference["losses"])
    (logits, displ), (ref_logits, ref_displ) = program["outputs"], reference["outputs"]
    out = {"logit_gap": output_gap(logits, ref_logits)}
    if ref_displ is not None:
        out["displ_gap"] = output_gap(displ, ref_displ)
    return {**out,
            "loss_gap": losses[0],
            "loss_gap_mean": statistics.fmean(losses),
            "grad_gap_worst": max(grad),
            "grad_gap": statistics.median(grad),
            "change_gap_worst": max(change),
            "change_gap": statistics.median(change)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit; a number that is missing or not
    finite fails."""
    return all(n in numbers and numbers[n] == numbers[n] and numbers[n] <= lim
               for n, lim in limits.items())
