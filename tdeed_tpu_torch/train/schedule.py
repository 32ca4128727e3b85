"""LR schedule and optimizer (port of tdeed_tpu/train/schedule.py).

The reference chains LinearLR warmup and CosineAnnealingLR, both stepping
every optimizer step (ref: train_tdeed.py:79-87), which multiplies their
factors:
    lr(t) = base * linear(t) * cosine(t)
    linear(t) = 0.01 + 0.99 * min(t, W) / W          (start_factor=0.01)
    cosine(t) = (1 + cos(pi * t / C)) / 2            (T_max = C, eta_min = 0)
Reference quirk, kept for parity: training runs W steps past C, so the
cosine factor passes its minimum and rises again over the last W steps.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch


def chained_warmup_cosine(
    base_lr: float, warmup_steps: int, cosine_steps: int
) -> Callable[[int], float]:
    """step -> learning rate."""
    w = max(1, int(warmup_steps))
    c = max(1, int(cosine_steps))

    def schedule(step: int) -> float:
        linear = 0.01 + 0.99 * min(step, w) / w
        cosine = 0.5 * (1.0 + math.cos(math.pi * step / c))
        return base_lr * linear * cosine

    return schedule


def make_optimizer(
    params,
    base_lr: float,
    warmup_steps: int,
    cosine_steps: int,
    weight_decay: float = 0.01,
) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW (betas .9/.999, eps 1e-8, decay on all params, no param groups;
    ref: model/modules.py:37-39) and its per-step schedule. Step the
    scheduler after every optimizer step: update t then uses lr(t)."""
    opt = torch.optim.AdamW(
        params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay,
    )
    sched = chained_warmup_cosine(base_lr, warmup_steps, cosine_steps)
    return opt, torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: sched(step) / base_lr
    )
