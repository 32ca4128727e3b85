"""GSM and GSF (Gate-Shift-Fuse) compute core (port of
tdeed_tpu/kernels/gated_shift.py:gsf_core and the gating of
tdeed_tpu/models/shift.py:GSM).

Written from the JAX package's direct-convolution oracles
(``gsf_gate_conv``, ``gsf_post_gate_conv``): a grouped 3-D gate conv
(C -> 2, groups 2) + tanh, a gated +-1-frame shift with zero fill, spatially
pooled statistics, two 3x3 fusion convs and sigmoid blends
(ref: model/impl/gsf.py:9-93). The JAX package's factored 54-column gate
GEMM worked around padding on the TPU's matrix unit and has no reason to
exist here: the convs are stock cuDNN calls.

Tensors are (B, T, H, W, C) as in the JAX package; inside the trunk that
is a free view of the channels_last (B*T, C, H, W) activation. Weights are
in torch layout. The post-gate chain runs in the activation's dtype with
fp32 spatial means, as the JAX package measured for bf16 training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdeed_tpu_torch.kernels.batchnorm import acc_dtype
from tdeed_tpu_torch.ops.temporal import lshift_zero, rshift_zero


def gsf_gate(xn, gate_w, gate_b):
    """tanh(conv3d(xn) + b) over (T, H, W), SAME zero padding.

    xn: (B, T, H, W, C) post BN+ReLU; gate_w: (2, C//2, 3, 3, 3);
    gate_b: (2,). Returns the gate (B, T, H, W, 2) in fp32 (or wider)."""
    x5 = xn.permute(0, 4, 1, 2, 3)  # (B, C, T, H, W)
    g = F.conv3d(x5, gate_w.to(xn.dtype), None, padding=1, groups=2)
    g = g.to(acc_dtype(g)) + gate_b.to(acc_dtype(g)).view(1, 2, 1, 1, 1)
    g = torch.tanh(g)
    return g.permute(0, 2, 3, 4, 1)


def _fuse(y, r, w, b):
    """Blend y and r with sigmoid(conv2d([mean_hw y, mean_hw r])) weights
    over the (channel, time) plane (ref: gsf.py:46-93)."""
    acc = acc_dtype(y)
    ym = y.mean(dim=(2, 3), dtype=acc).transpose(1, 2)  # (B, C', T)
    rm = r.mean(dim=(2, 3), dtype=acc).transpose(1, 2)
    stat = torch.stack([ym, rm], dim=1)  # (B, 2, C', T)
    wmap = torch.sigmoid(F.conv2d(stat, w.to(acc), b.to(acc), padding=1))
    wm = wmap[:, 0].transpose(1, 2)[:, :, None, None, :].to(y.dtype)
    return y * wm + r * (1 - wm)


def gate_shift(x, gate):
    """The gating and shift GSM and GSF share (ref: gsm.py:83-87): each
    half of x: (B, T, H, W, C) times its gate channel is shifted one frame
    along T (the first half back, the second forward, zero fill); the rest
    is the residual. Returns (y1, y2, r1, r2) in x's dtype."""
    c = x.shape[-1]
    gate = gate.to(x.dtype)
    g1, g2 = gate[..., 0:1], gate[..., 1:2]
    x1, x2 = x[..., : c // 2], x[..., c // 2:]
    y1, y2 = g1 * x1, g2 * x2
    return lshift_zero(y1, dim=1), rshift_zero(y2, dim=1), x1 - y1, x2 - y2


def gsf_post_gate(x, gate, ch1_w, ch1_b, ch2_w, ch2_b):
    """Gating, shift and fusion given the tanh gate. x: (B, T, H, W, C) in
    the activation dtype; ch*_w: (1, 2, 3, 3). Returns the blended head
    before the channel interleave, in x's dtype."""
    y1, y2, r1, r2 = gate_shift(x, gate)
    return torch.cat(
        [_fuse(y1, r1, ch1_w, ch1_b), _fuse(y2, r2, ch2_w, ch2_b)], dim=-1
    )


def gsf_core(x, xn, gate_w, gate_b, ch1_w, ch1_b, ch2_w, ch2_b):
    """Full post-BN GSF math on (B, T, H, W, C), C divisible by 4."""
    gate = gsf_gate(xn, gate_w, gate_b)
    return gsf_post_gate(x, gate, ch1_w, ch1_b, ch2_w, ch2_b)
