"""Checkpoints: weights, optimizer, schedule and step count (port of
tdeed_tpu/checkpoint.py; ``torch.save`` takes the place of orbax).

The reference saves model weights only (best-epoch ``state_dict`` —
ref: train_tdeed.py:226-238, model/modules.py:47-55), so a crashed run
restarts from scratch. Here the training state is saved too, with the
epoch counter and the running best-criterion value, giving true
mid-training resume on top of the reference's best-checkpoint semantics.

Layout under ``save_dir``:
    checkpoint_best  — the best epoch's model ``state_dict`` under the
                       reference names (``TDEED.load_state_dict(strict=True)``
                       takes it; parity with the reference's
                       checkpoint_best.pt)
    checkpoint_last  — the most recent ``TrainStep.state_dict()``: model,
                       optimizer, schedule and the optimizer-step count,
                       which places the loader and seeds the step's draws,
                       so a resumed run continues exactly (resume point)
    train_meta.json  — {'epoch', 'best_criterion', 'history'}
    loss.json        — the history (ref: train_tdeed.py:226-229)

Every file is written beside its target and swapped in with os.replace:
a crash mid-save never destroys the only resume point. Restores load onto
``map_location`` (the CPU by default); ``load_state_dict`` then copies
into the model and optimizer on their own device.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

BEST = "checkpoint_best"
LAST = "checkpoint_last"
META = "train_meta.json"


def _replace_with(path: str, write) -> None:
    """Call ``write(tmp)`` on a temporary path beside ``path``, then swap it
    in: the previous file stays whole until the new one is complete."""
    path = os.path.abspath(path)
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def _write_json(path: str, obj: Any, **kw) -> None:
    def write(tmp):
        with open(tmp, "w") as fp:
            json.dump(obj, fp, indent=2, **kw)

    _replace_with(path, write)


def save_state(path: str, state) -> None:
    """Write a training-state checkpoint: ``state.state_dict()`` of a
    train.step.TrainStep (model, optimizer, schedule, step)."""
    sd = state.state_dict()
    _replace_with(path, lambda tmp: torch.save(sd, tmp))


def restore_state(path: str, template, map_location="cpu"):
    """Load a training-state checkpoint into ``template`` (a TrainStep over
    a model and optimizer of the same shapes) and return it."""
    template.load_state_dict(torch.load(path, map_location=map_location))
    return template


def save_params(path: str, model: torch.nn.Module) -> None:
    """Weights-only checkpoint (the reference's state_dict equivalent)."""
    sd = model.state_dict()
    _replace_with(path, lambda tmp: torch.save(sd, tmp))


def restore_params(path: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location=map_location)


class CheckpointManager:
    """Best/last checkpoint pair + metadata, reference-compatible semantics."""

    def __init__(self, save_dir: str):
        self.save_dir = save_dir
        os.makedirs(save_dir, exist_ok=True)

    @property
    def meta_path(self) -> str:
        return os.path.join(self.save_dir, META)

    def load_meta(self) -> Dict[str, Any]:
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as fp:
                return json.load(fp)
        return {"epoch": -1, "best_criterion": None, "history": []}

    def save_meta(self, meta: Dict[str, Any]) -> None:
        _write_json(self.meta_path, meta)

    def save_epoch(
        self,
        state,
        epoch: int,
        record: Dict[str, Any],
        is_best: bool,
        best_criterion: Optional[float],
    ) -> None:
        """After an epoch: ``state`` (a TrainStep) to checkpoint_last, its
        model to checkpoint_best when ``is_best``, then the meta."""
        meta = self.load_meta()
        meta["epoch"] = epoch
        meta["best_criterion"] = best_criterion
        meta["history"].append(record)
        save_state(os.path.join(self.save_dir, LAST), state)
        if is_best:
            save_params(os.path.join(self.save_dir, BEST), state.model)
        self.save_meta(meta)
        _write_json(os.path.join(self.save_dir, "loss.json"), meta["history"],
                    sort_keys=True)

    def restore_last(self, template, map_location="cpu") -> Tuple[Any, int]:
        """(state, next_epoch) — for resume; (template, 0) when nothing saved.

        A ``checkpoint_last`` without meta (interrupt-save before the first
        ``save_epoch``) still restores: the caller derives the exact
        epoch/batch position from the state's step count, so next_epoch
        falls back to 0 rather than discarding the saved state."""
        last = os.path.join(self.save_dir, LAST)
        if not os.path.exists(last):
            return template, 0
        meta = self.load_meta()
        return restore_state(last, template, map_location), max(0, meta["epoch"] + 1)

    def restore_best(self, map_location="cpu") -> Dict[str, torch.Tensor]:
        """The best epoch's model state_dict."""
        return restore_params(os.path.join(self.save_dir, BEST), map_location)
