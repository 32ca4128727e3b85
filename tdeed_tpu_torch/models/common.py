"""Shared layers: compute-dtype convs and linears, exact GELU, and the
split-precision batch norm (port of tdeed_tpu/models/common.py).

Parameters stay fp32. Every layer here casts its parameters to the dtype of
its input, so a bf16 input runs the layer in bf16 — the counterpart of the
flax ``dtype=`` attribute. Initializers are torch's defaults unless a
module says otherwise, which is what the JAX package reproduces with
``torch_kernel_init``/``torch_bias_init``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from tdeed_tpu_torch.parallel import mesh


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


class Conv1d(nn.Conv1d):
    """nn.Conv1d run in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        )


class Conv2d(nn.Conv2d):
    """nn.Conv2d run in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        )


class Conv3d(nn.Conv3d):
    """nn.Conv3d run in the input's dtype."""

    def forward(self, x):
        return self._conv_forward(
            x, self.weight.to(x.dtype), _cast(self.bias, x.dtype)
        )


class Linear(nn.Linear):
    """nn.Linear run in the input's dtype."""

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype), _cast(self.bias, x.dtype))


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype statistics accumulate in: fp32, or the input's if wider."""
    return torch.promote_types(x.dtype, torch.float32)


def gelu_exact(x):
    """torch nn.GELU's default erf form (tdeed_tpu/models/common.py:50)."""
    return F.gelu(x, approximate="none")


class _BatchMoments(torch.autograd.Function):
    """Per-channel E[x] and E[x^2] in fp32 (or wider) over every dim but 1,
    over the global batch of ``group`` when it has more than one rank.

    Autograd over ``x.float()`` would keep an fp32 copy of every normalized
    activation for the backward pass (twice the bf16 activation itself).
    This keeps only ``x`` and recomputes the fp32 view in the backward,
    with the same gradient: d/dx = (g_mean + 2 x g_sq) / n.

    Over W ranks of equal shards (parallel/mesh.py) the forward averages
    the W local moments (one all-reduce of both), the counterpart of the
    JAX step's moments over its sharded global batch. Each rank then
    differentiates its own loss L_r, and the step averages the parameter
    gradients over the ranks, which is the gradient of the mean of the
    L_r. The moments feed every rank's loss, so the backward sums the W
    incoming (g_mean, g_sq) (a second all-reduce) and divides by the
    global count n W: rank r's d/dx is then d(sum_s L_s)/dx_r, as in the
    local gradients of the other layers."""

    @staticmethod
    def forward(ctx, x, group=None):
        dims = [d for d in range(x.ndim) if d != 1]
        xf = x.to(acc_dtype(x))
        mean, sq = xf.mean(dims), xf.square().mean(dims)
        world = mesh.world(group)
        if world > 1:
            moments = torch.stack([mean, sq])
            dist.all_reduce(moments, group=group)
            mean, sq = (moments / world).unbind(0)
        ctx.save_for_backward(x)
        ctx.group, ctx.world = group, world
        return mean, sq

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        (x,) = ctx.saved_tensors
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        n = x.numel() // x.shape[1] * ctx.world
        if ctx.world > 1:
            grads = torch.stack([g_mean, g_sq])
            dist.all_reduce(grads, group=ctx.group)
            g_mean, g_sq = grads[0], grads[1]
        g = g_mean.view(shape) + 2.0 * x.to(acc_dtype(x)) * g_sq.view(shape)
        return (g / n).to(x.dtype), None


class SplitBatchNorm(nn.Module):
    """BatchNorm with fp32 statistics and a compute-dtype application
    (tdeed_tpu/models/common.py:106-157).

    Channels are dim 1. Training normalizes with the biased batch variance
    E[x^2] - E[x]^2 and folds the normalization into one ``x * a + b`` in
    the input's dtype. The running statistics follow flax: momentum 0.9 on
    the old value (torch's 0.1) and the *biased* variance, which is why
    plain nn.BatchNorm2d (unbiased running variance) is not used. Buffer
    names are torch's, so reference checkpoints load unchanged.

    With a ``process_group`` of more than one rank (set by
    parallel.mesh.distribute) the training statistics are the global
    batch's: every rank normalises with the same moments and writes the
    same running statistics. Eval mode never communicates.
    nn.SyncBatchNorm is not used either: it keeps the unbiased running
    variance and runs in one precision.
    """

    momentum = 0.9  # flax convention: weight of the old running value

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        # False while a checkpointed block recomputes its forward in the
        # backward pass (frozen_running_stats): the step already wrote them
        self.update_stats = True
        self.process_group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer(
            "num_batches_tracked", torch.tensor(0, dtype=torch.long)
        )

    def forward(self, x):
        if self.training:
            mean, sq = _BatchMoments.apply(x, self.process_group)
            var = sq - mean.square()
            if self.update_stats:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                    self.running_var.copy_(m * self.running_var + (1 - m) * var)
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = self.weight * torch.rsqrt(var + self.eps)
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        a = inv.to(x.dtype).view(shape)
        b = (self.bias - mean * inv).to(x.dtype).view(shape)
        return x * a + b


@contextlib.contextmanager
def frozen_running_stats(module: nn.Module):
    """Within, every SplitBatchNorm under ``module`` normalises as before
    but leaves its running statistics and ``num_batches_tracked`` alone:
    the recompute of a checkpointed block (models/regnet.py) repeats a
    forward whose statistics the step has already taken."""
    bns = [m for m in module.modules() if isinstance(m, SplitBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True
