"""SGP temporal encoder-decoder (port of tdeed_tpu/models/sgp.py).

Blocks take and return (B, T, C) like the JAX package and work inside in
torch's (B, C, T) conv layout. Attribute names are the reference's
(ref: model/modules.py:58-318): ``ln``, ``gn``, ``psi``, ``fc``, ``convw``,
``convkw``, ``global_fc``, ``mlp.{0,2}`` in SGPBlock; ``ln1/ln2``,
``psi1/2``, ``convw1/2``, ``convkw1/2``, ``fc1/2``, ``global_fc1/2``,
``concat_fc`` in SGPMixer; ``_sgp.{i}`` / ``_sgpMixer.{i}`` in the U-Net.

  SGPBlock:  out = ln(x); out = fc(out)*relu(gfc(mean_T(out)))
                   + (convw(out)+convkw(out))*psi(out) + out;
             out = x + out; out = out + mlp(gn(out))     (modules.py:159-188)
  SGPMixer:  dual-branch fusion of upsampled decoder state and skip, 6-way
             concat -> 1x1 conv -> GELU, + FFN           (modules.py:283-318)
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from tdeed_tpu_torch.models.common import Conv1d, acc_dtype, gelu_exact
from tdeed_tpu_torch.ops.temporal import adaptive_max_pool1d, linear_upsample


def _up_size(kernel_size: int, k: float) -> int:
    """Window-branch kernel size: round((ks+1)*k), forced odd (modules.py:119-120)."""
    if kernel_size % 2 != 1:
        raise ValueError(f"sgp kernel size must be odd, got {kernel_size}")
    up = round((kernel_size + 1) * k)
    return up + 1 if up % 2 == 0 else up


class _DWConv(Conv1d):
    """Depthwise temporal conv on (B, C, T), N(0, init_std) kernel, zero
    bias (ref: model/modules.py:122-126, init at :147-157)."""

    def __init__(self, c: int, kernel_size: int, init_std: float = 0.1):
        super().__init__(c, c, kernel_size, padding=kernel_size // 2, groups=c)
        nn.init.normal_(self.weight, std=init_std)
        nn.init.zeros_(self.bias)


class _ChannelLayerNorm(nn.Module):
    """LayerNorm over C of (B, C, T), fp32 statistics; parameters shaped
    (1, C, 1) as in the reference (ref: model/modules.py:320-363)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(1, c, 1))
        self.bias = nn.Parameter(torch.zeros(1, c, 1))

    def forward(self, x):
        xf = x.to(acc_dtype(x))
        mu = xf.mean(dim=1, keepdim=True)
        var = (xf - mu).square().mean(dim=1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(x.dtype)


def _attach_ffn(owner: nn.Module, c: int) -> None:
    """Register the FFN's GroupNorm(16) and 1x1-conv MLP with 4x hidden
    (modules.py:115,134-138) on the owning block: the reference state_dict
    keys them ``gn`` and ``mlp.{0,2}`` at block level."""
    owner.gn = nn.GroupNorm(16, c, eps=1e-5)
    owner.mlp = nn.Sequential(Conv1d(c, 4 * c, 1), nn.GELU(), Conv1d(4 * c, c, 1))


def _ffn(owner: nn.Module, x):
    """x + mlp(gn(x)) on (B, C, T), GroupNorm statistics in fp32
    (the JAX package's _FFN)."""
    gn = owner.gn
    h = F.group_norm(x.to(acc_dtype(x)), gn.num_groups, gn.weight, gn.bias, gn.eps)
    return x + owner.mlp(h.to(x.dtype))


class SGPBlock(nn.Module):
    """Scalable-Granularity Perception block (ref: model/modules.py:89-188)."""

    def __init__(self, c: int, kernel_size: int = 3, k: float = 1.5,
                 init_conv_vars: float = 0.1):
        super().__init__()
        up = _up_size(kernel_size, k)
        std = init_conv_vars
        self.ln = _ChannelLayerNorm(c)
        self.psi = _DWConv(c, kernel_size, std)
        self.fc = _DWConv(c, 1, std)
        self.convw = _DWConv(c, kernel_size, std)
        self.convkw = _DWConv(c, up, std)
        self.global_fc = _DWConv(c, 1, std)
        _attach_ffn(self, c)

    def forward(self, x):  # (B, T, C)
        x = x.transpose(1, 2)
        out = self.ln(x)
        phi = torch.relu(self.global_fc(out.mean(dim=2, keepdim=True)))
        out = (
            self.fc(out) * phi
            + (self.convw(out) + self.convkw(out)) * self.psi(out)
            + out
        )
        out = _ffn(self, x + out)
        return out.transpose(1, 2)


class SGPMixer(nn.Module):
    """Decoder fusion block: skip z + upsampled x (ref: model/modules.py:190-318)."""

    def __init__(self, c: int, t_size: int, kernel_size: int = 3,
                 k: float = 1.5, init_conv_vars: float = 0.1):
        super().__init__()
        up = _up_size(kernel_size, k)
        std = init_conv_vars
        self.t_size = t_size
        self.ln1 = _ChannelLayerNorm(c)
        self.ln2 = _ChannelLayerNorm(c)
        self.psi1 = _DWConv(c, kernel_size, std)
        self.psi2 = _DWConv(c, kernel_size, std)
        self.convw1 = _DWConv(c, kernel_size, std)
        self.convkw1 = _DWConv(c, up, std)
        self.convw2 = _DWConv(c, kernel_size, std)
        self.convkw2 = _DWConv(c, up, std)
        self.fc1 = _DWConv(c, 1, std)
        self.fc2 = _DWConv(c, 1, std)
        self.global_fc1 = _DWConv(c, 1, std)
        self.global_fc2 = _DWConv(c, 1, std)
        self.concat_fc = Conv1d(6 * c, c, 1)
        nn.init.normal_(self.concat_fc.weight, std=std)
        nn.init.zeros_(self.concat_fc.bias)
        _attach_ffn(self, c)

    def forward(self, x, z):
        # x: (B, T_small, C) decoder state; z: (B, t_size, C) encoder skip
        z = self.ln1(z.transpose(1, 2))
        x = self.ln2(x.transpose(1, 2))
        x = linear_upsample(x.transpose(1, 2), self.t_size).transpose(1, 2)
        phi1 = torch.relu(self.global_fc1(z.mean(dim=2, keepdim=True)))
        phi2 = torch.relu(self.global_fc2(x.mean(dim=2, keepdim=True)))
        out1 = (self.convw1(z) + self.convkw1(z)) * self.psi1(z)
        out2 = (self.convw2(x) + self.convkw2(x)) * self.psi2(x)
        out3 = self.fc1(z) * phi1
        out4 = self.fc2(x) * phi2
        cat = torch.cat([out1, out2, out3, out4, z, x], dim=1)
        out = gelu_exact(self.concat_fc(cat))
        return _ffn(self, out).transpose(1, 2)


class EDSGPMixer(nn.Module):
    """Temporal U-Net: L SGP encoder levels, a bottleneck, L mixer+SGP
    decoder levels (ref: model/modules.py:58-87). Level i has length
    ceil(T / 2**i). Input and output (B, T, C)."""

    def __init__(self, c: int, clip_len: int, num_layers: int = 2,
                 kernel_size: int = 3, k: float = 2.0, k_factor: int = 2):
        super().__init__()
        self.num_layers = num_layers
        self.lens = [
            math.ceil(clip_len / (k_factor ** i)) for i in range(num_layers + 1)
        ]
        self._sgp = nn.ModuleList(
            SGPBlock(c, kernel_size, k) for _ in range(2 * num_layers + 1)
        )
        self._sgpMixer = nn.ModuleList(
            SGPMixer(c, self.lens[i], kernel_size, k) for i in range(num_layers)
        )

    def forward(self, x):
        n = self.num_layers
        skips = []
        for i in range(n):
            x = self._sgp[i](x)
            skips.append(x)
            x = adaptive_max_pool1d(x, self.lens[i + 1])
        x = self._sgp[n](x)
        for i in range(n):
            j = n - 1 - i  # the reference indexes mixers back to front
            x = self._sgpMixer[j](x, skips[j])
            x = self._sgp[n + i + 1](x)
        return x
