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
import torch.nn as nn
import torch.nn.functional as F

from tdeed_tpu_torch.kernels.batchnorm import batch_norm_train, bn_fold


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


def gelu_exact(x):
    """torch nn.GELU's default erf form (tdeed_tpu/models/common.py:50)."""
    return F.gelu(x, approximate="none")


class SplitBatchNorm(nn.Module):
    """BatchNorm with fp32 statistics and a compute-dtype application
    (tdeed_tpu/models/common.py:106-157), then ReLU when ``relu``.

    Channels are dim 1. Training normalizes with the biased batch variance
    E[x^2] - E[x]^2 and folds the normalization into one ``x * a + b`` in
    the input's dtype. The running statistics follow flax: momentum 0.9 on
    the old value (torch's 0.1) and the *biased* variance, which is why
    plain nn.BatchNorm2d (unbiased running variance) is not used. Buffer
    names are torch's, so reference checkpoints load unchanged.

    Training runs ``kernels.batchnorm.batch_norm_train``: four CUDA kernels
    for a CUDA input, which must hold its channels innermost in memory
    (channels_last), and their plain twin for a CPU input. Eval mode is the
    stock ``x * a + b`` with the running statistics, which torch.export
    traces.

    With a ``process_group`` of more than one rank (set by
    parallel.mesh.distribute) the training statistics are the global
    batch's: every rank normalises with the same moments and writes the
    same running statistics. Eval mode never communicates.
    nn.SyncBatchNorm is not used either: it keeps the unbiased running
    variance and runs in one precision.
    """

    def __init__(self, num_features: int, eps: float = 1e-5, relu: bool = False):
        super().__init__()
        self.eps = eps
        self.relu = relu
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
            running = None
            if self.update_stats:
                running = (self.running_mean, self.running_var, self.num_batches_tracked)
            y, _ = batch_norm_train(x, self.weight, self.bias, self.eps, self.relu, running,
                                    self.process_group)
            return y
        a, b = bn_fold(self.running_mean, self.running_var, self.weight, self.bias, self.eps, x)
        y = x * a + b
        return torch.relu(y) if self.relu else y


@contextlib.contextmanager
def frozen_running_stats(*modules: nn.Module):
    """Within, every SplitBatchNorm under ``modules`` normalises as before
    but leaves its running statistics and ``num_batches_tracked`` alone:
    the recompute of a checkpointed block (models/regnet.py) repeats a
    forward whose statistics the step has already taken."""
    bns = [m for module in modules for m in module.modules()
           if isinstance(m, SplitBatchNorm)]
    for m in bns:
        m.update_stats = False
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = True
