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
import re
from typing import Any, Dict, Optional, Tuple

import torch

from tdeed_tpu_torch.parallel.mesh import unwrap

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
    """Weights-only checkpoint (the reference's state_dict equivalent), of
    the bare module under a data-parallel wrapper: no ``module.`` keys."""
    sd = unwrap(model).state_dict()
    _replace_with(path, lambda tmp: torch.save(sd, tmp))


def restore_params(path: str, map_location="cpu") -> Dict[str, torch.Tensor]:
    return torch.load(path, map_location=map_location)


_TIMM_BLOCK_RE = re.compile(r"^s(\d+)\.b(\d+)\.(.*)$")
_TIMM_BN = ("bn.weight", "bn.bias", "bn.running_mean", "bn.running_var")


def _timm_key_kept(rest: str, in_block: bool) -> bool:
    """The keys tools/import_timm_weights.py:convert_state_dict maps, below
    ``stem.`` or ``s{i}.b{j}.``: the ConvBN's conv weight and BN (weights
    and running statistics, not the counter) and, in a block, the SE convs."""
    if rest == "conv.weight" or rest in _TIMM_BN:
        return True
    if not in_block:
        return False
    if rest.startswith(("conv1.", "conv2.", "conv3.", "downsample.")):
        return _timm_key_kept(rest.split(".", 1)[1], False)
    parts = rest.split(".")  # se.<fc>.weight / se.<fc>.bias
    return len(parts) == 3 and parts[0] == "se" and parts[2] in ("weight", "bias")


def load_backbone(model: torch.nn.Module, path: str) -> Dict[str, str]:
    """Overlay a timm RegNet-Y state dict file (``torch.save`` of
    ``timm.create_model('regnety_002' / 'regnety_008').state_dict()``, or
    timm's ``.pth``) onto ``model._features``, in place; returns {trunk
    key: file key} of what it wrote.

    The reference always starts from ImageNet-pretrained timm weights
    (ref: model/model.py:37-46). The rules are the JAX package's: the key
    mapping of tools/import_timm_weights.py:convert_state_dict (``head.*``
    and keys without a counterpart are skipped), the checks of
    tdeed_tpu/checkpoint.py:overlay_tree (every kept key must exist in the
    trunk with the same shape, else the load raises naming it), and the
    shift modules (``gs``) keep their init. In a shifted block timm's
    ``conv1.*`` lands on the wrapped conv, ``conv1.net.*``.

    The JAX package's ``backbone_ckpt`` names the orbax directory that
    tool writes, which only JAX reads; the port reads the file the tool
    starts from, and refuses a directory."""
    if os.path.isdir(path):
        raise ValueError(
            f"backbone_ckpt {path!r} is a directory, the JAX package's orbax backbone; "
            "the port reads the timm RegNet-Y state dict file (torch.save or timm's .pth) "
            "that tools/import_timm_weights.py converts from"
        )
    sd = torch.load(path, map_location="cpu", weights_only=True)
    trunk = model._features.state_dict()
    written = {}
    for key, value in sd.items():
        m = _TIMM_BLOCK_RE.match(key)
        if key.startswith("stem."):
            kept = _timm_key_kept(key[len("stem."):], False)
        else:
            kept = m is not None and _timm_key_kept(m.group(3), True)
        if not kept:
            continue
        dst = key
        if m and m.group(3).startswith("conv1.") and \
                f"s{m.group(1)}.b{m.group(2)}.conv1.net.conv.weight" in trunk:
            dst = key.replace(".conv1.", ".conv1.net.", 1)
        if dst not in trunk:
            raise KeyError(f"backbone_ckpt key {key!r} has no counterpart {dst!r} in the trunk")
        value = torch.as_tensor(value)
        if tuple(value.shape) != tuple(trunk[dst].shape):
            raise ValueError(f"backbone_ckpt key {key!r}: shape {tuple(value.shape)}, "
                             f"the trunk's {dst!r} is {tuple(trunk[dst].shape)}")
        written[dst] = key
        with torch.no_grad():
            trunk[dst].copy_(value)
    return written


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
