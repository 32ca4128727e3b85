"""Temporal primitives of the SGP encoder-decoder on (B, T, C) sequences
(port of tdeed_tpu/ops/temporal.py).

The JAX package expresses pooling and upsampling as static gathers and
matmuls for XLA; here pooling is torch's own operator and upsampling two
CUDA kernels on the card (kernels/upsample.py), F.interpolate elsewhere,
with the reference semantics (ref: model/modules.py:64,236).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdeed_tpu_torch.kernels import upsample


def adaptive_max_pool1d(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """nn.AdaptiveMaxPool1d(t_out) over the T axis of (B, T, C)."""
    if x.shape[1] == t_out:
        return x
    return F.adaptive_max_pool1d(x.transpose(1, 2), t_out).transpose(1, 2)


def tracing() -> bool:
    """Whether ``torch.compile`` or ``torch.export`` is tracing the caller:
    a traced program keeps ATen's operator, and an exported one must load
    without this package's kernels."""
    return torch.compiler.is_compiling() or torch.compiler.is_exporting()


def linear_upsample(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """nn.Upsample(mode='linear', align_corners=True) of (B, T, C) to
    (B, t_out, C): the kernels for a CUDA tensor outside a trace, else
    F.interpolate. Either way the result is a (B, t_out, C) view of a
    dense (B, C, t_out) tensor."""
    xt = x.transpose(1, 2)
    if not tracing() and x.is_cuda:
        y = upsample.linear_upsample(xt, t_out)
    else:
        y = F.interpolate(xt, size=t_out, mode="linear", align_corners=True)
    return y.transpose(1, 2)


def lshift_zero(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """y[t] = x[t + 1] along ``dim``, zero at the end (ref: gsm.py:83-84)."""
    body = x.narrow(dim, 1, x.shape[dim] - 1)
    return torch.cat([body, torch.zeros_like(x.narrow(dim, 0, 1))], dim)


def rshift_zero(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """y[t] = x[t - 1] along ``dim``, zero at the start (ref: gsm.py:86-87)."""
    body = x.narrow(dim, 0, x.shape[dim] - 1)
    return torch.cat([torch.zeros_like(x.narrow(dim, 0, 1)), body], dim)
