"""Train and predict steps (port of tdeed_tpu/train/step.py).

One training step: batch-wide random crop -> mixup blend (rounded once to
bf16) -> fused photometric kernel -> model forward in the config's dtype
with fp32 parameters -> weighted CE + displacement MSE -> backward ->
AdamW + schedule step (ref: model/model.py:193-332).

With ``acc_grad_iter`` > 1 the batch is split into that many micro-batches
of B/acc_grad_iter clips; each gets its own draws, a train-mode forward
(BN running statistics update once per micro-batch) and a backward of its
loss over acc_grad_iter, so the gradients and the loss are means over
micro-batches; then one AdamW step and one schedule step
(tdeed_tpu/train/step.py:170-190).

Randomness is injected, not reproduced: ``TrainStep.draw`` makes every
random value of a step — per micro-batch, the crop offset, mixup weights,
the (b, 16) augment parameters (slot 14 the flip gate) and the dropout
masks — and the step also takes them from outside, so tests can hand the
same values to the JAX package. The draws of step t come from generators
seeded with (seed, t) alone, as the JAX step folds the step into its key
(:164): a run resumed from a checkpoint at step t draws what the
uninterrupted run drew.

Joint two-dataset training (``two_heads`` = (C1+1, C2+1)): each clip of
the batch carries a ``dataset`` id in {1, 2}; a head-2 clip's labels are
offset by C1+1 into the two-head label space, mixup blends over all
C1+1 + C2+1 classes, and each clip's loss is its own head's
(``losses.double_head_ce``; tdeed_tpu/train/step.py:103-148).

Data parallelism (parallel/mesh.py): a model that ``distribute`` gave a
process group of W ranks takes its BatchNorm moments over the global
micro-batch. Each rank passes the step its own rows of the global batch
(``mesh.global_rows``), draws the global micro-batch's random values from
(seed, step) and keeps its rows of them, so W ranks draw what one process
draws; the hard CE divides by the global weight sum; the gradients and
the loss are averaged over the ranks once per optimizer step, after the
last micro-batch. The val step's loss is the global batch's.

``pallas_augment`` False runs the plain photometric chain on the model's
device in place of the kernel (``train_preprocess_plain``); None and True
launch the kernel on a CUDA device. On the CPU every setting runs the
plain chain.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tdeed_tpu_torch.kernels.augment import (
    sample_params,
    train_preprocess,
    train_preprocess_plain,
)
from tdeed_tpu_torch.models.heads import DROPOUT_RATE
from tdeed_tpu_torch.ops.displacement import decode_displacement
from tdeed_tpu_torch.parallel import mesh
from tdeed_tpu_torch.train import augment
from tdeed_tpu_torch.train.losses import (
    class_weights,
    displacement_mse,
    double_head_ce,
    weighted_ce_hard,
    weighted_ce_soft,
)
from tdeed_tpu_torch.utils.profiling import annotate


@dataclass
class StepDraws:
    """Every random value one micro-batch of b clips uses."""

    crop: Optional[Tuple[int, int]]  # micro-batch-wide crop offset (i, j)
    lam: Optional[torch.Tensor]  # (b,) fp32 mixup weights, mixup only
    aug: torch.Tensor  # (b, 16) fp32 photometric params, flip in slot 14
    dropout_keep: Dict[str, torch.Tensor]  # head name -> (b, T, D) bool


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on(x, device):
    return None if x is None else torch.as_tensor(x).to(device, non_blocking=True)


def _head2_offset(label, dataset_id, num_classes_bg: int):
    """Head-2 clips' labels shifted past head 1's classes
    (ref: model/model.py:371-376)."""
    return torch.where(dataset_id[:, None] == 2, label + num_classes_bg, label)


class TrainStep:
    """Callable training step; see make_train_step. ``step`` counts the
    optimizer steps taken; ``state_dict`` and ``load_state_dict`` carry the
    model, optimizer, schedule and that count (checkpoint.py)."""

    def __init__(self, model, optimizer, scheduler, *, crop_dim, num_classes_bg,
                 mixup, radi_displacement, acc_grad_iter=1, fg_weight=5.0, seed=0,
                 pallas_augment=None):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.crop_dim = crop_dim
        self.num_classes_bg = num_classes_bg
        self.mixup = mixup
        self.radi_displacement = radi_displacement
        self.acc_grad_iter = acc_grad_iter
        self.pallas_augment = pallas_augment
        self.group = mesh.group_of(model)
        self.rank, self.world = mesh.rank(self.group), mesh.world(self.group)
        dev = _device_of(model)
        self.weights = class_weights(num_classes_bg, fg_weight, dev)
        self.two_heads = model.two_heads
        self.weights2 = (class_weights(self.two_heads[1], fg_weight, dev)
                         if self.two_heads else None)
        self.total_bg = sum(self.two_heads) if self.two_heads else num_classes_bg
        self.seed = seed
        self.step = 0

    def state_dict(self) -> Dict:
        return {
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "step": self.step,
        }

    def load_state_dict(self, state: Dict) -> None:
        self.model.load_state_dict(state["model"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.step = int(state["step"])

    def _micro_size(self, batch) -> int:
        b = batch["frame"].shape[0]
        if b % self.acc_grad_iter:
            raise ValueError(f"batch {b} does not split into {self.acc_grad_iter} micro-batches")
        return b // self.acc_grad_iter

    def draw(self, batch) -> List[StepDraws]:
        """Draw this step's random values for ``batch`` on the host: one
        StepDraws per micro-batch, in order, from generators seeded with
        (seed, step). Over W ranks each draws for the global micro-batch of
        W b clips and keeps its rows, [r b, (r + 1) b)."""
        b = self._micro_size(batch)
        rows = slice(self.rank * b, (self.rank + 1) * b)
        b *= self.world
        _, t, h, w, _ = batch["frame"].shape
        seq = np.random.SeedSequence([self.seed, self.step])
        generator = torch.Generator().manual_seed(int(seq.generate_state(1, np.uint64)[0]))
        np_rng = np.random.default_rng(seq)
        heads = self.model.dropout_heads
        d = self.model.feat_dim
        draws = []
        for _ in range(self.acc_grad_iter):
            crop = augment.sample_crop_offset(generator, (h, w), self.crop_dim)
            lam = None
            if self.mixup:
                lam = torch.from_numpy(augment.sample_mixup_lam(np_rng, b))
            aug = sample_params(generator, b)
            keep = {
                name: torch.rand(b, t, d, generator=generator) >= DROPOUT_RATE
                for name in heads
            }
            if self.world > 1:
                lam = None if lam is None else lam[rows]
                aug = aug[rows]
                keep = {name: k[rows] for name, k in keep.items()}
            draws.append(StepDraws(crop, lam, aug, keep))
        return draws

    def _loss(self, batch, draws: StepDraws, dev) -> torch.Tensor:
        """Train-mode loss of one micro-batch."""
        # One crop offset for the whole micro-batch and a pointwise blend, so
        # crop-then-blend equals blend-then-crop; cropping first blends
        # fewer pixels (tdeed_tpu/train/step.py:92-101).
        frames = augment.random_crop_batch(
            _on(batch["frame"], dev), self.crop_dim, draws.crop
        )
        label = _on(batch["label"], dev).long()
        label_d = _on(batch.get("labelD"), dev)
        dataset_id = _on(batch.get("dataset"), dev)
        routed = self.two_heads is not None and dataset_id is not None
        if routed:
            label = _head2_offset(label, dataset_id, self.num_classes_bg)
        soft = None
        if self.mixup:
            frames2 = augment.random_crop_batch(
                _on(batch["frame2"], dev), self.crop_dim, draws.crop
            )
            label2 = _on(batch["label2"], dev).long()
            if routed:
                label2 = _head2_offset(label2, dataset_id, self.num_classes_bg)
            with annotate("mixup"):
                frames, soft, label_d = augment.mixup_batch(
                    frames, label, frames2, label2,
                    draws.lam.to(dev), self.total_bg,
                    label_d, _on(batch.get("labelD2"), dev),
                )
        preprocess = train_preprocess_plain if self.pallas_augment is False else train_preprocess
        x = preprocess(frames, draws.aug.to(dev, non_blocking=True))
        keep = {k: v.to(dev, non_blocking=True) for k, v in draws.dropout_keep.items()}
        out = self.model(x, dropout_keep=keep)

        logits = out["logits"]
        c = logits.shape[-1]
        if routed:
            loss = double_head_ce(
                logits, soft if soft is not None else label, dataset_id,
                self.num_classes_bg, self.weights, self.weights2, soft=soft is not None,
            )
        elif soft is not None:
            loss = weighted_ce_soft(
                logits.reshape(-1, c), soft.reshape(-1, c), self.weights
            )
        else:
            loss = weighted_ce_hard(
                logits.reshape(-1, c), label.reshape(-1), self.weights, self.group
            )
        if self.radi_displacement > 0 and label_d is not None:
            loss = loss + displacement_mse(out["displ"], label_d)
        return loss

    def __call__(self, batch, draws: Optional[Sequence[StepDraws]] = None
                 ) -> Dict[str, torch.Tensor]:
        """One optimizer step on ``batch`` (dict of (B, T, H, W, 3) uint8
        'frame', (B, T) int 'label', optional 'labelD', with mixup
        'frame2'/'label2'/'labelD2', and with two heads the (B,) 'dataset'
        ids; tensors or numpy arrays), with
        ``draws`` from ``draw`` (one per micro-batch) or drawn here.
        Returns {'loss': the micro-batches' mean loss, a detached fp32
        scalar on the model's device}; over W ranks ``batch`` is the rank's
        rows and the loss is the global batch's."""
        dev = _device_of(self.model)
        b = self._micro_size(batch)
        if draws is None:
            draws = self.draw(batch)
        if len(draws) != self.acc_grad_iter:
            raise ValueError(f"{len(draws)} draws for {self.acc_grad_iter} micro-batches")
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        total = None
        for i, d in enumerate(draws):
            micro = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
            loss = self._loss(micro, d, dev)
            (loss / self.acc_grad_iter).backward()
            total = loss.detach() if total is None else total + loss.detach()
        if self.group is not None:
            # once per optimizer step: the gradients and the loss in one
            # all-reduce per dtype
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            mesh.all_reduce_mean_(grads + [total], self.group)
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1
        return {"loss": total / self.acc_grad_iter}


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
    seed: int = 0,
    pallas_augment: Optional[bool] = None,
) -> TrainStep:
    """Build the training step over ``model`` with ``optimizer`` and
    ``scheduler`` from train.schedule.make_optimizer. ``seed`` and the
    step count seed each step's draws. The batch (B divisible by
    ``acc_grad_iter``) is taken as ``acc_grad_iter`` micro-batches. The
    step runs on the device of the model's parameters (``build_model``
    puts them on the CUDA device unless asked for the CPU) and moves each
    batch there. A model with ``two_heads`` (C1+1, C2+1) routes each clip
    to its dataset's head. ``pallas_augment`` False runs the plain
    photometric chain in place of the kernel. A model that
    ``parallel.mesh.distribute`` gave a process group trains data-parallel
    over its ranks (see the module docstring)."""
    return TrainStep(
        model, optimizer, scheduler, crop_dim=crop_dim,
        num_classes_bg=num_classes_bg, mixup=mixup,
        radi_displacement=radi_displacement, acc_grad_iter=acc_grad_iter,
        fg_weight=fg_weight, seed=seed, pallas_augment=pallas_augment,
    )


def make_val_step(model, *, crop_dim: Optional[int], num_classes_bg: int,
                  radi_displacement: int, fg_weight: float = 5.0):
    """Validation loss step (port of tdeed_tpu/train/step.py:205-247):
    val_step(batch) -> {'loss', 'logits' (B, T, C+1), 'displ' (B, T) when
    the head exists}, on the model's device, under no_grad. Eval
    preprocessing (center crop, no augmentation), running BN statistics,
    no dropout (ref: model/model.py:196-198). With the model's
    ``two_heads`` each clip of a batch with 'dataset' ids takes its own
    head's loss. Over the ranks of the model's process group the batch is
    the rank's rows and the loss is the global batch's."""
    two_heads = model.two_heads
    group = mesh.group_of(model)
    dev = _device_of(model)
    weights = class_weights(num_classes_bg, fg_weight, dev)
    weights2 = class_weights(two_heads[1], fg_weight, dev) if two_heads else None

    @torch.no_grad()
    def val_step(batch) -> Dict[str, torch.Tensor]:
        model.eval()
        label = _on(batch["label"], dev).long()
        dataset_id = _on(batch.get("dataset"), dev)
        out = model(augment.eval_preprocess(_on(batch["frame"], dev), crop_dim))
        logits = out["logits"]
        c = logits.shape[-1]
        if two_heads is not None and dataset_id is not None:
            loss = double_head_ce(
                logits, _head2_offset(label, dataset_id, num_classes_bg), dataset_id,
                num_classes_bg, weights, weights2, soft=False,
            )
        else:
            loss = weighted_ce_hard(logits.reshape(-1, c), label.reshape(-1), weights, group)
        if radi_displacement > 0 and "labelD" in batch:
            loss = loss + displacement_mse(out["displ"], _on(batch["labelD"], dev))
        if group is not None:
            mesh.all_reduce_mean_([loss], group)
        aux = {"loss": loss, "logits": logits}
        if radi_displacement > 0:
            aux["displ"] = out["displ"]
        return aux

    return val_step


def predict_scores(model, frames, *, crop_dim: Optional[int], radi_displacement: int,
                   hflip: bool = False):
    """The predict step's computation on (B, T, H, W, 3) uint8 ``frames``
    already on the model's device, in the model's current mode: (argmax
    (B, T), scores (B, T, C)). The serving export (infer/export.py) traces
    it."""
    x = augment.eval_preprocess(frames, crop_dim, hflip)
    out = model(x)
    logits = out["logits"]
    if model.two_heads is not None:
        logits = logits[..., :model.two_heads[0]]
    probs = torch.softmax(logits, dim=-1)
    if radi_displacement > 0:
        probs = decode_displacement(probs, out["displ"])
    return probs.argmax(dim=-1), probs


def make_predict_step(model, *, crop_dim: Optional[int], radi_displacement: int):
    """Inference step: predict(frames, hflip=False) -> (argmax (B, T),
    scores (B, T, C)), softmax scores displacement-decoded when the head
    exists (ref: model/model.py:334-369). hflip selects the TTA pass. It
    runs on the device of the model's parameters and moves the frames
    there. With the model's ``two_heads`` the scores are head 1's alone,
    (B, T, C1+1) (ref: model/modules.py:416-426)."""

    @torch.no_grad()
    def predict(frames, hflip: bool = False):
        model.eval()
        return predict_scores(model, _on(frames, _device_of(model)), crop_dim=crop_dim,
                              radi_displacement=radi_displacement, hflip=hflip)

    return predict
