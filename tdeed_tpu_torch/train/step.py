"""Train and predict steps (port of tdeed_tpu/train/step.py).

One training step: batch-wide random crop -> mixup blend (rounded once to
bf16) -> fused photometric kernel -> model forward in the config's dtype
with fp32 parameters -> weighted CE + displacement MSE -> backward ->
AdamW + schedule step (ref: model/model.py:193-332).

Randomness is injected, not reproduced: ``TrainStep.draw`` makes every
random value of a step — crop offset, mixup weights, the (B, 16) augment
parameters (slot 14 the flip gate) and the dropout masks — from the step's
own torch.Generator (and a numpy Generator for the Beta draws), and the
step also takes them from outside, so tests can hand the same values to
the JAX package. ``acc_grad_iter > 1``, the double head and the
validation step are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tdeed_tpu_torch.kernels.augment import sample_params, train_preprocess
from tdeed_tpu_torch.models.heads import DROPOUT_RATE
from tdeed_tpu_torch.models.tdeed import refuse
from tdeed_tpu_torch.ops.displacement import decode_displacement
from tdeed_tpu_torch.train import augment
from tdeed_tpu_torch.train.losses import (
    class_weights,
    displacement_mse,
    weighted_ce_hard,
    weighted_ce_soft,
)
from tdeed_tpu_torch.utils.profiling import annotate


@dataclass
class StepDraws:
    """Every random value one training step uses."""

    crop: Optional[Tuple[int, int]]  # batch-wide crop offset (i, j)
    lam: Optional[torch.Tensor]  # (B,) fp32 mixup weights, mixup only
    aug: torch.Tensor  # (B, 16) fp32 photometric params, flip in slot 14
    dropout_keep: Dict[str, torch.Tensor]  # head name -> (B, T, D) bool


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(x, device):
    return None if x is None else torch.as_tensor(x).to(device, non_blocking=True)


class TrainStep:
    """Callable training step; see make_train_step."""

    def __init__(self, model, optimizer, scheduler, *, crop_dim, num_classes_bg,
                 mixup, radi_displacement, fg_weight=5.0, seed=0):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.crop_dim = crop_dim
        self.num_classes_bg = num_classes_bg
        self.mixup = mixup
        self.radi_displacement = radi_displacement
        self.weights = class_weights(num_classes_bg, fg_weight, _device_of(model))
        self.generator = torch.Generator().manual_seed(seed)
        self.np_rng = np.random.default_rng(seed)

    def draw(self, batch) -> StepDraws:
        """Draw one step's random values for ``batch`` on the host."""
        b, t, h, w, _ = batch["frame"].shape
        crop = augment.sample_crop_offset(self.generator, (h, w), self.crop_dim)
        lam = None
        if self.mixup:
            lam = torch.from_numpy(augment.sample_mixup_lam(self.np_rng, b))
        aug = sample_params(self.generator, b)
        heads = ["pred_fine"] + (["pred_displ"] if self.radi_displacement > 0 else [])
        d = self.model.feat_dim
        keep = {
            name: torch.rand(b, t, d, generator=self.generator) >= DROPOUT_RATE
            for name in heads
        }
        return StepDraws(crop, lam, aug, keep)

    def __call__(self, batch, draws: Optional[StepDraws] = None) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (dict of (B, T, H, W, 3) uint8
        'frame', (B, T) int 'label', optional 'labelD', and with mixup
        'frame2'/'label2'/'labelD2'; tensors or numpy arrays). Returns
        {'loss': detached fp32 scalar}."""
        model = self.model
        dev = _device_of(model)
        if draws is None:
            draws = self.draw(batch)
        model.train()

        # One crop offset for the whole batch and a pointwise blend, so
        # crop-then-blend equals blend-then-crop; cropping first blends
        # fewer pixels (tdeed_tpu/train/step.py:92-101).
        frames = augment.random_crop_batch(
            _on(batch["frame"], dev), self.crop_dim, draws.crop
        )
        label = _on(batch["label"], dev).long()
        label_d = _on(batch.get("labelD"), dev)
        soft = None
        if self.mixup:
            frames2 = augment.random_crop_batch(
                _on(batch["frame2"], dev), self.crop_dim, draws.crop
            )
            with annotate("mixup"):
                frames, soft, label_d = augment.mixup_batch(
                    frames, label, frames2, _on(batch["label2"], dev),
                    draws.lam.to(dev), self.num_classes_bg,
                    label_d, _on(batch.get("labelD2"), dev),
                )
        x = train_preprocess(frames, draws.aug.to(dev, non_blocking=True))
        keep = {k: v.to(dev, non_blocking=True) for k, v in draws.dropout_keep.items()}
        out = model(x, dropout_keep=keep)

        logits = out["logits"]
        c = logits.shape[-1]
        if soft is not None:
            loss = weighted_ce_soft(
                logits.reshape(-1, c), soft.reshape(-1, c), self.weights
            )
        else:
            loss = weighted_ce_hard(
                logits.reshape(-1, c), label.reshape(-1), self.weights
            )
        if self.radi_displacement > 0 and label_d is not None:
            loss = loss + displacement_mse(out["displ"], label_d)

        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        self.scheduler.step()
        return {"loss": loss.detach()}


def make_train_step(
    model,
    optimizer,
    scheduler,
    *,
    crop_dim: Optional[int],
    num_classes_bg: int,
    mixup: bool,
    radi_displacement: int,
    acc_grad_iter: int = 1,
    fg_weight: float = 5.0,
    two_heads=None,
    seed: int = 0,
) -> TrainStep:
    """Build the training step over ``model`` with ``optimizer`` and
    ``scheduler`` from train.schedule.make_optimizer. ``seed`` seeds the
    step's generators. The step runs on the device of the model's
    parameters (``build_model`` puts them on the CUDA device unless asked
    for the CPU) and moves each batch there."""
    if acc_grad_iter != 1:
        refuse(f"acc_grad_iter={acc_grad_iter}", "acc_grad_iter scan")
    if two_heads is not None:
        refuse("two_heads", "FC2 double head")
    return TrainStep(
        model, optimizer, scheduler, crop_dim=crop_dim,
        num_classes_bg=num_classes_bg, mixup=mixup,
        radi_displacement=radi_displacement, fg_weight=fg_weight, seed=seed,
    )


def make_predict_step(model, *, crop_dim: Optional[int], radi_displacement: int,
                      two_heads=None):
    """Inference step: predict(frames, hflip=False) -> (argmax (B, T),
    scores (B, T, C)), softmax scores displacement-decoded when the head
    exists (ref: model/model.py:334-369). hflip selects the TTA pass. It
    runs on the device of the model's parameters and moves the frames
    there."""
    if two_heads is not None:
        refuse("two_heads", "FC2 double head")

    @torch.no_grad()
    def predict(frames, hflip: bool = False):
        model.eval()
        x = augment.eval_preprocess(_on(frames, _device_of(model)), crop_dim, hflip)
        out = model(x)
        probs = torch.softmax(out["logits"], dim=-1)
        if radi_displacement > 0:
            probs = decode_displacement(probs, out["displ"])
        return probs.argmax(dim=-1), probs

    return predict
