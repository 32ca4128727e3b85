"""The yardstick's counts: the H100's published peaks, the bytes the
photometric kernel K1 must move, and the model's forward FLOPs.

Peaks: one H100 SXM, NVIDIA's data sheet, dense, at 700 W.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import model as M

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
K1_PARAMS = 16  # fp32 parameters a clip
K1_OUT_BYTES = 2  # bf16


def k1_frame_bytes(shape: Sequence[int], in_bytes: int) -> int:
    """K1's frames at ``shape`` (B, T, H, W, 3): each input byte read once
    (``in_bytes`` a value: 1 for uint8, 2 for the bf16 mixup blend) and
    each bf16 output byte written once."""
    return math.prod(shape) * (in_bytes + K1_OUT_BYTES)


def k1_bytes(shape: Sequence[int], in_bytes: int) -> int:
    """All K1 must move at ``shape``: the frames, and the (B, 16) fp32
    parameters read once."""
    return k1_frame_bytes(shape, in_bytes) + shape[0] * K1_PARAMS * 4


def k1_least_s(shape: Sequence[int], in_bytes: int) -> float:
    """K1's least time on the card: its bytes at the peak bandwidth (its
    arithmetic, a few dozen operations a pixel, is far below the FLOP
    bound)."""
    return k1_bytes(shape, in_bytes) / PEAK_BYTES_PER_S


def conv_flops(n: int, cin: int, cout: int, kh: int, kw: int, oh: int, ow: int,
               groups: int = 1) -> int:
    """FLOPs of one 2-D convolution: a multiply and an add per weight tap
    per output value."""
    return 2 * n * cout * oh * ow * (cin // groups) * kh * kw


def forward_flops(spec: M.Spec, frames: int, h: int, w: int) -> float:
    """The model's forward FLOPs on ``frames`` frames of (h, w): its
    convolutions and matrix products, as ``FlopCounterMode`` counts them
    over the reference model on shapes alone (the meta device), one clip
    of ``spec.clip_len`` frames scaled to ``frames``."""
    P = {k: torch.empty(shape, device="meta") for k, (shape, _) in M.shapes(spec).items()}
    x = torch.empty(1, spec.clip_len, h, w, 3, device="meta")
    with FlopCounterMode(display=False) as counter:
        M.forward(P, spec, x, M.State(train=True))
    return counter.get_total_flops() * frames / spec.clip_len
