"""Serialized serving artifacts: the predict step as ``torch.export``
programs (port of tdeed_tpu/infer/export.py, which writes StableHLO).

The reference serves predictions only in-process, through its python
evaluation loop (ref: util/eval.py:290-349). The deployment unit here is
the traced program itself: ``torch.export`` captures the predict step
with the weights inside it, and any PyTorch process loads and calls it
with ``torch.export.load`` alone, without this package or its checkpoint
format.

An export is a directory:

    predict.pt2         hflip=False pass
    predict_hflip.pt2   hflip=True pass (TTA; same input spec)
    manifest.json       shapes, classes, windowing protocol fields

Both passes take one input, ``frames`` (batch, clip_len, H, W, 3) uint8 on
the device the program was exported on, and return ``(argmax, probs)``
exactly like ``make_predict_step``'s callable: preprocessing (scale,
center crop, standardise, flip) is inside the program. The manifest
carries what the surrounding host loop needs to rebuild the
sliding-window protocol (stride, overlap, pad, NMS windows, class map);
its keys are the JAX manifest's, with ``platforms`` the device type the
program runs on and ``torch_version`` in place of ``jax_version``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tdeed_tpu_torch.data.registry import DEFAULT_PAD_LEN, get_spec
from tdeed_tpu_torch.infer.evaluate import INFERENCE_BATCH_SIZE

_PREDICT = "predict.pt2"
_PREDICT_HFLIP = "predict_hflip.pt2"
_MANIFEST = "manifest.json"


class _PredictPass(torch.nn.Module):
    """One pass of the predict step with its flip fixed, as a module for
    ``torch.export`` (the step itself is a no_grad closure)."""

    def __init__(self, model, crop_dim, radi_displacement, hflip):
        super().__init__()
        self.model = model
        self.crop_dim = crop_dim
        self.radi_displacement = radi_displacement
        self.hflip = hflip

    def forward(self, frames):
        from tdeed_tpu_torch.train.step import predict_scores

        return predict_scores(self.model, frames, crop_dim=self.crop_dim,
                              radi_displacement=self.radi_displacement, hflip=self.hflip)


def export_predictor(
    cfg,
    state_dict: Dict[str, torch.Tensor],
    classes: Dict[str, int],
    out_dir: str,
    *,
    two_heads: Optional[Tuple[int, int]] = None,
    batch_size: int = INFERENCE_BATCH_SIZE,
    frame_hw: Optional[Tuple[int, int]] = None,
    device="cuda",
) -> str:
    """Export the predict step of the model ``cfg`` builds, with
    ``state_dict`` inside it, to ``out_dir``; returns out_dir.

    frame_hw: spatial shape of the *stored* frames fed to the program
      (center-cropped to cfg.crop_dim inside); defaults to
      (crop_dim, crop_dim), i.e. frames already at model resolution.
    device: where the programs run: the CUDA device unless the caller asks
      for the CPU. Without a card, "cuda" raises (build_model).
    """
    from tdeed_tpu_torch.models.tdeed import build_model

    model = build_model(cfg, two_heads, device=device)
    model.load_state_dict(state_dict, strict=True)
    model.eval()
    dev = next(model.parameters()).device
    hw = frame_hw or (cfg.crop_dim, cfg.crop_dim)
    example = torch.zeros((batch_size, cfg.clip_len, hw[0], hw[1], 3), dtype=torch.uint8,
                          device=dev)

    os.makedirs(out_dir, exist_ok=True)
    for hflip, fname in ((False, _PREDICT), (True, _PREDICT_HFLIP)):
        step = _PredictPass(model, cfg.crop_dim, cfg.radi_displacement, hflip)
        with torch.no_grad():
            program = torch.export.export(step, (example,))
        # the program keeps its example input, which save would write
        # beside the weights (a 4-clip batch of 256^2 frames is 79 MB)
        program.example_inputs = None
        torch.export.save(program, os.path.join(out_dir, fname))

    spec = get_spec(cfg.dataset)
    manifest = {
        "model": cfg.model,
        "dataset": cfg.dataset,
        "batch_size": batch_size,
        "clip_len": cfg.clip_len,
        "crop_dim": cfg.crop_dim,
        "frame_hw": list(hw),
        "radi_displacement": cfg.radi_displacement,
        "two_heads": list(two_heads) if two_heads else None,
        "classes": classes,
        "platforms": [dev.type],
        "torch_version": torch.__version__,
        # sliding-window protocol (ref: train_tdeed.py:30-33, util/eval.py:25-31)
        "eval_stride": spec.eval_stride,
        "overlap_len": spec.eval_overlap_len(cfg.clip_len),
        "pad_len": DEFAULT_PAD_LEN,
        "hflip_tta": spec.hflip_tta,
        "nms_windows": list(spec.windows),
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as fp:
        json.dump(manifest, fp, indent=1)
    return out_dir


class ExportedPredictor:
    """Call a serialized export: ``argmax, probs = ep(frames, hflip=...)``.

    Loads both programs with ``torch.export.load``; it needs torch, not the
    model code. Host frames (numpy or CPU tensors) are moved to the device
    the artifact was exported on; an artifact for "cuda" raises without a
    card, it never falls back to the CPU.
    """

    def __init__(self, export_dir: str):
        with open(os.path.join(export_dir, _MANIFEST)) as fp:
            self.manifest = json.load(fp)
        (platform,) = self.manifest["platforms"]
        if platform == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"ExportedPredictor: {export_dir} was exported for cuda and there is no "
                "CUDA device (torch.cuda.is_available() is False); export with "
                "device='cpu' to serve on the CPU"
            )
        self.device = torch.device(platform)
        self._calls = {}
        for hflip, fname in ((False, _PREDICT), (True, _PREDICT_HFLIP)):
            program = torch.export.load(os.path.join(export_dir, fname))
            self._calls[hflip] = program.module()

    def __call__(self, frames, hflip: bool = False):
        """(batch, clip_len, H, W, 3) uint8 -> (argmax (B,T), probs (B,T,C+1))
        on the artifact's device."""
        m = self.manifest
        want = (m["batch_size"], m["clip_len"], *m["frame_hw"], 3)
        if tuple(np.shape(frames)) != want:
            raise ValueError(
                f"exported program takes frames{list(want)} uint8, got "
                f"{list(np.shape(frames))} (pad ragged batches to batch_size)"
            )
        with torch.no_grad():
            return self._calls[bool(hflip)](torch.as_tensor(frames).to(self.device))
