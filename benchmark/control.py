"""The readings the check's limits are set from, on the card at a cell's
own size: the program's numbers over many seeds, the control's (the
reference in float8 in the program's place) and the faults'.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

One process, one JSON line a seed and kind of reading:
  program  the program as the cell runs it, against the float32 reference
  control  the reference through per-tensor-scaled float8 rounding: e4m3
           for every convolution's and linear layer's input, weight and
           output and every normalisation's output, e5m2 for the
           gradients flowing back through them
  half     a step whose loss leaves half of each batch out and takes the
           mean over the rest
A training state left unchanged reads 1 by ``change_gap_worst``'s measure
and needs no run. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from benchmark import compare
from benchmark.reference import model as M
from benchmark.run import plan


def half_batch():
    """Patch the program's training loss to take half of each batch: the
    fault of a step that drops rows and averages the rest."""
    from tdeed_tpu_torch.train.step import StepDraws, TrainStep

    original = TrainStep._loss

    def _loss(self, batch, draws, dev):
        h = batch["frame"].shape[0] // 2
        half = {k: v[:h] for k, v in batch.items()}
        d = StepDraws(draws.crop, None if draws.lam is None else draws.lam[:h], draws.aug[:h],
                      {k: v[:h] for k, v in draws.dropout_keep.items()})
        return original(self, half, d, dev)

    TrainStep._loss = _loss
    return lambda: setattr(TrainStep, "_loss", original)


def training(kind, cfg_file, mix, seed, with_control: bool):
    out = []
    cell = kind.Cell(cfg_file, mix, seed)
    program = cell.program
    cell.free()
    reference = cell.reference()
    out.append(("program", compare.training_gaps(program, reference)))
    if with_control:
        out.append(("control", compare.training_gaps(cell.reference(quant=M.fp8), reference)))
        del cell
        undo = half_batch()
        try:
            faulty = kind.Cell(cfg_file, mix, seed)
        finally:
            undo()
        faulty.free()
        out.append(("half", compare.training_gaps(faulty.program, reference)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control-seeds", default="", help="comma-separated; also read the control "
                   "and the faults on these")
    args = p.parse_args(argv)
    _, cfg_file, mix, _, _, _ = plan(args.workload)

    kind = importlib.import_module(f"benchmark.kinds.{mix['kind']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t = time.perf_counter()
        rows = training(kind, cfg_file, mix, seed, seed in controls)
        for what, numbers in rows:
            print(json.dumps({"workload": args.workload, "seed": seed, "reading": what,
                              **numbers, "seconds": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
