"""Preprocessing around the augmentation kernel (port of
tdeed_tpu/train/augment.py): crops, mixup, eval preprocessing.

Random values are inputs here (crop offsets, mixup weights); the train
step draws them, so tests can hand both frameworks the same values.
The photometric chain itself is kernels/augment.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def standardize(x: torch.Tensor) -> torch.Tensor:
    """ImageNet mean/std over the last (channel) dim (ref: model/model.py:87-89)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def center_crop(x: torch.Tensor, crop: Optional[int]) -> torch.Tensor:
    """Center crop of (..., H, W, C)."""
    if crop is None:
        return x
    h, w = x.shape[-3], x.shape[-2]
    i, j = (h - crop) // 2, (w - crop) // 2
    return x[..., i:i + crop, j:j + crop, :]


def sample_crop_offset(
    generator: torch.Generator, hw: Tuple[int, int], crop: Optional[int]
) -> Optional[Tuple[int, int]]:
    """One (i, j) RandomCrop offset for the whole batch, uniform over every
    valid position (ref: model/model.py:110-116). None without a crop."""
    if crop is None:
        return None
    h, w = hw
    i = torch.randint(0, h - crop + 1, (), generator=generator).item()
    j = torch.randint(0, w - crop + 1, (), generator=generator).item()
    return int(i), int(j)


def random_crop_batch(
    x: torch.Tensor, crop: Optional[int], offset: Optional[Tuple[int, int]]
) -> torch.Tensor:
    """Crop (B, T, H, W, C) at the batch-wide ``offset`` from
    sample_crop_offset. Returns a view."""
    if crop is None:
        return x
    i, j = offset
    return x[:, :, i:i + crop, j:j + crop, :]


def sample_mixup_lam(rng: np.random.Generator, batch: int) -> np.ndarray:
    """Per-sample Beta(0.2, 0.2) mixup weights (ref: model/model.py:237),
    drawn on the host: torch.distributions takes no generator."""
    return rng.beta(0.2, 0.2, size=batch).astype(np.float32)


def mixup_labels(labels, labels2, lam, num_classes_bg, label_d=None, label_d2=None):
    """Soft label distributions (B, T, C) and mixed displacement targets
    for per-sample weights lam (B,) (ref: model/model.py:236-254)."""
    lam_t = lam.float()[:, None]  # (B, 1)
    soft = F.one_hot(labels.long(), num_classes_bg) * lam_t[..., None] + F.one_hot(
        labels2.long(), num_classes_bg
    ) * (1.0 - lam_t[..., None])
    mixed_d = None
    if label_d is not None:
        mixed_d = lam_t * label_d.float() + (1.0 - lam_t) * label_d2.float()
    return soft, mixed_d


def mixup_batch(frames, labels, frames2, labels2, lam, num_classes_bg,
                label_d=None, label_d2=None):
    """Blend two batches with per-sample weights lam (B,) on frames' device
    (ref: model/model.py:228-254). The fp32 blend is rounded once to bf16,
    as in the JAX package (:215-223). Returns (mixed bf16 frames, soft
    labels (B, T, C), mixed displacement targets)."""
    lam5 = lam.float().view(-1, 1, 1, 1, 1)
    mixed = lam5 * frames.float() + (1.0 - lam5) * frames2.float()
    soft, mixed_d = mixup_labels(
        labels, labels2, lam, num_classes_bg, label_d, label_d2
    )
    return mixed.to(torch.bfloat16), soft, mixed_d


def eval_preprocess(frames: torch.Tensor, crop_dim: Optional[int],
                    hflip: bool = False) -> torch.Tensor:
    """(B, T, H, W, 3) uint8/float -> standardized fp32, center-cropped,
    optionally flipped (TTA pass; ref: model/model.py:120-129)."""
    x = center_crop(frames, crop_dim).float() / 255.0
    if hflip:
        x = x.flip(3)
    return standardize(x)
