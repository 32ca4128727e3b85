"""Shared layers: compute-dtype convs and linears, exact GELU, and the
split-precision batch norm (port of tdeed_tpu/models/common.py).

Parameters stay fp32. Every layer here casts its parameters to the dtype of
its input, so a bf16 input runs the layer in bf16 — the counterpart of the
flax ``dtype=`` attribute. Initializers are torch's defaults unless a
module says otherwise, which is what the JAX package reproduces with
``torch_kernel_init``/``torch_bias_init``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


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
    """Per-channel E[x] and E[x^2] in fp32 (or wider) over every dim but 1.

    Autograd over ``x.float()`` would keep an fp32 copy of every normalized
    activation for the backward pass (twice the bf16 activation itself).
    This keeps only ``x`` and recomputes the fp32 view in the backward,
    with the same gradient: d/dx = (g_mean + 2 x g_sq) / n."""

    @staticmethod
    def forward(ctx, x):
        dims = [d for d in range(x.ndim) if d != 1]
        xf = x.to(acc_dtype(x))
        mean = xf.mean(dims)
        sq = xf.square().mean(dims)
        ctx.save_for_backward(x)
        return mean, sq

    @staticmethod
    def backward(ctx, g_mean, g_sq):
        (x,) = ctx.saved_tensors
        shape = [1] * x.ndim
        shape[1] = x.shape[1]
        n = x.numel() // x.shape[1]
        g = g_mean.view(shape) + 2.0 * x.to(acc_dtype(x)) * g_sq.view(shape)
        return (g / n).to(x.dtype)


class SplitBatchNorm(nn.Module):
    """BatchNorm with fp32 statistics and a compute-dtype application
    (tdeed_tpu/models/common.py:106-157).

    Channels are dim 1. Training normalizes with the biased batch variance
    E[x^2] - E[x]^2 and folds the normalization into one ``x * a + b`` in
    the input's dtype. The running statistics follow flax: momentum 0.9 on
    the old value (torch's 0.1) and the *biased* variance, which is why
    plain nn.BatchNorm2d (unbiased running variance) is not used. Buffer
    names are torch's, so reference checkpoints load unchanged.
    """

    momentum = 0.9  # flax convention: weight of the old running value

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer(
            "num_batches_tracked", torch.tensor(0, dtype=torch.long)
        )

    def forward(self, x):
        if self.training:
            mean, sq = _BatchMoments.apply(x)
            var = sq - mean.square()
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
