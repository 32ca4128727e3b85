"""Gated temporal shift: GSF and the fold-dim wrapper (port of
tdeed_tpu/models/shift.py; GSM is not ported yet, see ROADMAP.md).

The reference splices a GatedShift into conv1 of every block of backbone
stages s3/s4 (ref: model/shift.py:46-93): the wrapper shifts the first
fold_dim channels with a _GSF module and then runs the wrapped conv. The
port keeps that structure and the reference attribute names (``gs``,
``net``, ``conv3D``, ``channel_conv1/2``), so a reference checkpoint's
``conv1.gs.*`` / ``conv1.net.*`` keys load as they are.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from tdeed_tpu_torch.kernels.gated_shift import gsf_core
from tdeed_tpu_torch.models.common import Conv2d, Conv3d, SplitBatchNorm


def fold_dim_for(channels: int, n_div: int = 4) -> int:
    """fold_dim = ceil((channels // n_div) / 4) * 4 (ref: model/shift.py:79)."""
    return math.ceil(channels // n_div / 4) * 4


def _interleave_halves(y1: torch.Tensor, y2: torch.Tensor) -> torch.Tensor:
    """The reference channel regroup (ref: gsm.py:110-116): each half is
    viewed as (2, C/4) on the last dim, transposed and re-flattened, then
    the halves are concatenated."""

    def regroup(y):
        *lead, c = y.shape
        return y.reshape(*lead, 2, c // 2).transpose(-1, -2).reshape(*lead, c)

    return torch.cat([regroup(y1), regroup(y2)], dim=-1)


class GSF(nn.Module):
    """Gate-Shift-Fuse on (B, T, H, W, C) (ref: model/impl/gsf.py:9-93).
    The gate conv keeps torch's default init (unlike GSM's zero init)."""

    def __init__(self, channels: int):
        super().__init__()
        if channels % 4:
            raise ValueError(f"GSF needs channels divisible by 4, got {channels}")
        self.conv3D = Conv3d(channels, 2, 3, padding=1, groups=2)
        self.bn = SplitBatchNorm(channels)
        self.channel_conv1 = Conv2d(2, 1, 3, padding=1)
        self.channel_conv2 = Conv2d(2, 1, 3, padding=1)

    def forward(self, x):
        c = x.shape[-1]
        # BN over channel dim 1 of the (B, C, T, H, W) view
        xn = torch.relu(self.bn(x.permute(0, 4, 1, 2, 3))).permute(0, 2, 3, 4, 1)
        out = gsf_core(
            x, xn,
            self.conv3D.weight, self.conv3D.bias,
            self.channel_conv1.weight, self.channel_conv1.bias,
            self.channel_conv2.weight, self.channel_conv2.bias,
        )
        return _interleave_halves(out[..., : c // 2], out[..., c // 2:])


class GatedShift(nn.Module):
    """Shift the first fold_dim channels of (B*T, C, H, W) with GSF, pass
    the rest through, then apply ``net`` (ref: model/shift.py:64-93).

    ``net`` is the wrapped conv1 inside the backbone; nn.Identity gives the
    bare shift of the JAX package's GatedShift."""

    def __init__(self, channels: int, clip_len: int, net: nn.Module):
        super().__init__()
        self.clip_len = clip_len
        self.fold = fold_dim_for(channels)
        self.gs = GSF(self.fold)
        self.net = net

    def forward(self, x):
        n, c, h, w = x.shape
        b = n // self.clip_len
        f = self.fold
        # channels_last memory makes this permute a view of (N, H, W, C)
        head = x[:, :f].permute(0, 2, 3, 1).reshape(b, self.clip_len, h, w, f)
        head = self.gs(head).reshape(n, h, w, f).permute(0, 3, 1, 2)
        out = torch.cat([head, x[:, f:]], dim=1)
        return self.net(out.contiguous(memory_format=torch.channels_last))
