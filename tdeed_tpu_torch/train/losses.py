"""Losses: foreground-weighted cross-entropy with hard and soft targets,
and displacement MSE (port of tdeed_tpu/train/losses.py; the double-head
routing waits with the FC2 head, see ROADMAP.md).

torch.nn.functional.cross_entropy semantics (ref: model/model.py:208-211,
276-319; fg class weight 5 at model.py:194):
  * hard targets with class weights -> weighted mean
        sum_i w[y_i] * nll_i / sum_i w[y_i]
  * soft targets with class weights -> plain mean over items of
        -sum_c w_c * t_c * log p_c
"""

from __future__ import annotations

import torch


def class_weights(num_classes_bg: int, fg_weight: float = 5.0,
                  device=None) -> torch.Tensor:
    """[1, fg, fg, ...] (ref: model/model.py:208-211)."""
    w = torch.full((num_classes_bg,), float(fg_weight), device=device)
    w[0] = 1.0
    return w


def weighted_ce_hard(logits, labels, weights):
    """logits (N, C) fp32, labels (N,) int, weights (C,): weighted mean."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    w = weights[labels.long()]
    return (w * nll).sum() / w.sum()


def weighted_ce_soft(logits, target, weights):
    """logits (N, C), target (N, C) probabilities: plain mean over N."""
    logp = torch.log_softmax(logits, dim=-1)
    return (-(weights[None, :] * target * logp).sum(dim=-1)).mean()


def displacement_mse(pred_d, label_d):
    """Mean squared error over all (B, T) positions (ref: model/model.py:316-319)."""
    return (pred_d.float() - label_d.float()).square().mean()
