"""Losses: foreground-weighted cross-entropy with hard and soft targets,
displacement MSE, and the double head's per-sample routing (port of
tdeed_tpu/train/losses.py).

torch.nn.functional.cross_entropy semantics (ref: model/model.py:208-211,
276-319; fg class weight 5 at model.py:194):
  * hard targets with class weights -> weighted mean
        sum_i w[y_i] * nll_i / sum_i w[y_i]
  * soft targets with class weights -> plain mean over items of
        -sum_c w_c * t_c * log p_c

Over W data-parallel ranks of equal shards, the train step averages each
rank's loss and gradients. That gives the global batch's value exactly for
every plain mean here: the soft CE, displacement_mse, and double_head_ce
(sum over clips / B). Only the hard CE's weighted mean divides by a sum
over the batch, which weighted_ce_hard takes over the process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tdeed_tpu_torch.parallel import mesh


def class_weights(num_classes_bg: int, fg_weight: float = 5.0,
                  device=None) -> torch.Tensor:
    """[1, fg, fg, ...] (ref: model/model.py:208-211)."""
    w = torch.full((num_classes_bg,), float(fg_weight), device=device)
    w[0] = 1.0
    return w


def weighted_ce_hard(logits, labels, weights, group=None):
    """logits (N, C) fp32, labels (N,) int, weights (C,): weighted mean.

    With a process ``group`` of W > 1 ranks (parallel/mesh.py), each
    holding an equal shard of the global batch, it returns W * (local sum
    of w * nll) / (global sum of w): the mean of the W ranks' values is
    then the global batch's weighted mean, and so is the mean of their
    gradients. The local sum of w alone would weight each rank's frames by
    its own foreground count."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[:, None].long())[:, 0]
    w = weights[labels.long()]
    total = w.sum()
    world = mesh.world(group)
    if world > 1:
        total = total.detach().clone()
        dist.all_reduce(total, group=group)
        return (w * nll).sum() * world / total
    return (w * nll).sum() / total


def weighted_ce_soft(logits, target, weights):
    """logits (N, C), target (N, C) probabilities: plain mean over N."""
    logp = torch.log_softmax(logits, dim=-1)
    return (-(weights[None, :] * target * logp).sum(dim=-1)).mean()


def displacement_mse(pred_d, label_d):
    """Mean squared error over all (B, T) positions (ref: model/model.py:316-319)."""
    return (pred_d.float() - label_d.float()).square().mean()


def double_head_ce(logits, target, dataset_id, num_classes1_bg: int,
                   weights1, weights2, soft: bool):
    """Per-sample routing of the two concatenated heads
    (ref: model/model.py:278-306).

    logits: (B, T, C1+C2); target: (B, T, C1+C2) soft distributions
    (already in the two-head label space) or (B, T) hard ids, offset by C1
    for head 2; dataset_id: (B,) in {1, 2}. Each sample contributes its
    head's CE over its T frames, / B. Both heads' losses are computed for
    every sample and one is kept; a hard id in the other head's range is
    clipped into this head's so that the gather stays in bounds (its loss
    is the one dropped)."""
    c1 = num_classes1_bg
    lg1, lg2 = logits[..., :c1], logits[..., c1:]
    if soft:
        l1 = _soft_ce_per_sample(lg1, target[..., :c1], weights1)
        l2 = _soft_ce_per_sample(lg2, target[..., c1:], weights2)
    else:
        target = target.long()
        l1 = _hard_ce_per_sample(lg1, target.clamp(0, c1 - 1), weights1)
        l2 = _hard_ce_per_sample(lg2, (target - c1).clamp(0, lg2.shape[-1] - 1), weights2)
    losses = torch.where(dataset_id.to(l1.device) == 1, l1, l2)
    return losses.sum() / logits.shape[0]


def _hard_ce_per_sample(logits, labels, weights):
    """weighted_ce_hard of each sample's (T, C) rows: (B,)."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels[..., None])[..., 0]
    w = weights[labels]
    return (w * nll).sum(dim=1) / w.sum(dim=1)


def _soft_ce_per_sample(logits, target, weights):
    """weighted_ce_soft of each sample's (T, C) rows: (B,)."""
    logp = torch.log_softmax(logits, dim=-1)
    return (-(weights * target * logp).sum(dim=-1)).mean(dim=1)
