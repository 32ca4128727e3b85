"""RegNet-Y backbone with GSM/GSF injection points (port of
tdeed_tpu/models/regnet.py).

Activations are NCHW tensors in channels_last memory. Module names follow
timm's RegNet (stem, s{i}.b{j}, conv1/conv2/conv3, se.fc1/fc2, downsample,
each ConvBN as conv + bn), which is also the ``_features.*`` part of the
reference T-DEED state_dict. With a shift, conv1 of every s3/s4 block is
wrapped by a GatedShift, so its keys fork into ``conv1.gs.*`` and
``conv1.net.*`` as in the reference; a plain trunk keeps timm's keys.

Checkpointing (``checkpoint_blocks``, the config's ``checkpoint_backbone``)
recomputes activations in the backward pass to save memory. The JAX
package wraps the whole trunk in one ``nn.remat`` (tdeed_tpu/models/
tdeed.py:56-58); in PyTorch one checkpoint over the trunk would recompute
and hold every trunk activation at once in the backward pass, so the peak
would barely fall. Here the stem and each block are checkpointed on their
own: only block inputs are kept, one block's activations are live at a
time in the backward pass, and the numbers are the same. The recompute
leaves the BN running statistics alone (``frozen_running_stats``), so a
step updates them once, as flax's remat does.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from tdeed_tpu_torch.models.common import Conv2d, SplitBatchNorm, frozen_running_stats
from tdeed_tpu_torch.models.shift import GatedShift

ARCH_PARAMS = {
    # timm regnety_002 / regnety_008 generation parameters, under the JAX
    # package's names for them
    "rny002": dict(w0=24, wa=36.44, wm=2.49, depth=13, group_size=8),
    "regnety_002": dict(w0=24, wa=36.44, wm=2.49, depth=13, group_size=8),
    "rny008": dict(w0=56, wa=38.84, wm=2.4, depth=14, group_size=16),
    "regnety_008": dict(w0=56, wa=38.84, wm=2.4, depth=14, group_size=16),
}

STEM_WIDTH = 32
SE_RATIO = 0.25


def generate_stages(
    w0: float, wa: float, wm: float, depth: int, group_size: int, q: int = 8
) -> Tuple[List[int], List[int], List[int]]:
    """RegNet width generation + group-compat adjustment (timm semantics).
    Returns (stage_widths, stage_depths, stage_groups)."""
    widths_cont = w0 + wa * np.arange(depth)
    ks = np.round(np.log(widths_cont / w0) / np.log(wm))
    widths = w0 * np.power(wm, ks)
    widths = (np.round(widths / q) * q).astype(int)
    stage_widths, stage_depths = np.unique(widths, return_counts=True)
    groups = [min(group_size, int(w)) for w in stage_widths]
    stage_widths = [int(round(w / g) * g) for w, g in zip(stage_widths, groups)]
    return stage_widths, [int(d) for d in stage_depths], groups


def _kaiming_fan_out(conv: nn.Conv2d) -> None:
    """N(0, 2/fan_out), the JAX package's variance_scaling(2, fan_out)."""
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")


class ConvBN(nn.Module):
    """Conv (no bias) + SplitBatchNorm + optional ReLU (the BatchNorm's
    own). Padding is torch's symmetric k//2, which the JAX package spells
    out explicitly because XLA's SAME differs at stride 2
    (regnet.py:82-93)."""

    def __init__(self, cin, cout, k=3, stride=1, groups=1, act=True):
        super().__init__()
        self.conv = Conv2d(
            cin, cout, k, stride=stride, padding=k // 2, groups=groups,
            bias=False,
        )
        _kaiming_fan_out(self.conv)
        self.bn = SplitBatchNorm(cout, relu=act)

    def forward(self, x):
        return self.bn(self.conv(x))


class SEModule(nn.Module):
    """Squeeze-and-excitation; the reduction width comes from the block
    *input* width (timm regnet: rd = round(in_chs * 0.25))."""

    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.fc1 = Conv2d(channels, rd_channels, 1)
        self.fc2 = Conv2d(rd_channels, channels, 1)
        for fc in (self.fc1, self.fc2):
            _kaiming_fan_out(fc)
            nn.init.zeros_(fc.bias)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(torch.relu(self.fc1(s)))
        return x * torch.sigmoid(s)


class YBlock(nn.Module):
    """RegNet-Y bottleneck block (bottle_ratio 1). With ``shift_mode``
    'gsm' or 'gsf', conv1 is wrapped by a GatedShift over clips of
    ``clip_len`` frames: the shift sees the block input, the shortcut does
    not (ref: model/shift.py:89-93)."""

    def __init__(self, in_width, width, stride, group_size,
                 shift_mode: Optional[str] = None, clip_len: Optional[int] = None):
        super().__init__()
        conv1 = ConvBN(in_width, width, 1)
        if shift_mode is not None:
            conv1 = GatedShift(in_width, clip_len, net=conv1, mode=shift_mode)
        self.conv1 = conv1
        self.conv2 = ConvBN(
            width, width, 3, stride=stride, groups=width // group_size
        )
        self.se = SEModule(width, int(round(in_width * SE_RATIO)))
        self.conv3 = ConvBN(width, width, 1, act=False)
        self.downsample = None
        if stride != 1 or in_width != width:
            self.downsample = ConvBN(in_width, width, 1, stride=stride, act=False)

    def forward(self, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        out = self.conv3(self.se(self.conv2(self.conv1(x))))
        return torch.relu(out + shortcut)


def _frozen_recompute(unit: nn.Module):
    """context_fn of a checkpointed unit: the forward as it is, the
    recompute with the running statistics of ``unit`` frozen."""
    return contextlib.nullcontext(), frozen_running_stats(unit)


class RegNetY(nn.Module):
    """RegNet-Y trunk -> global-average-pooled features (N, D).

    Input (N, 3, H, W), best in channels_last memory. ``shift_mode`` 'gsm'
    or 'gsf' puts that GatedShift, over clips of ``clip_len`` frames, in
    every block of stages 3 and 4 (ref: model/shift.py:57-59); None builds
    the plain trunk. ``checkpoint_blocks`` checkpoints the stem and each
    block in training (module docstring)."""

    def __init__(self, arch: str = "rny002", clip_len: Optional[int] = None,
                 shift_mode: Optional[str] = None, checkpoint_blocks: bool = False):
        super().__init__()
        if shift_mode is not None and not clip_len:
            raise ValueError(f"a {shift_mode} trunk needs clip_len")
        self.checkpoint_blocks = checkpoint_blocks
        p = ARCH_PARAMS[arch]
        widths, depths, groups = generate_stages(
            p["w0"], p["wa"], p["wm"], p["depth"], p["group_size"]
        )
        self.feat_dim = widths[-1]
        self.stem = ConvBN(3, STEM_WIDTH, 3, stride=2)
        in_w = STEM_WIDTH
        for si, (w, d, g) in enumerate(zip(widths, depths, groups)):
            blocks = {}
            for bi in range(d):
                blocks[f"b{bi + 1}"] = YBlock(
                    in_w, w, 2 if bi == 0 else 1, g,
                    shift_mode=shift_mode if si >= 2 else None, clip_len=clip_len,
                )
                in_w = w
            self.add_module(f"s{si + 1}", nn.ModuleDict(blocks))
        self.n_stages = len(widths)

    def forward(self, x):
        recompute = self.checkpoint_blocks and self.training and torch.is_grad_enabled()
        units = [self.stem] + [block for si in range(self.n_stages)
                               for block in getattr(self, f"s{si + 1}").values()]
        for unit in units:
            if recompute:
                x = checkpoint(unit, x, use_reentrant=False,
                               context_fn=functools.partial(_frozen_recompute, unit))
            else:
                x = unit(x)
        return x.mean(dim=(2, 3))
