"""Displacement-head decode (port of tdeed_tpu/ops/displacement.py)."""

from __future__ import annotations

import torch


def decode_displacement(probs: torch.Tensor, displ: torch.Tensor) -> torch.Tensor:
    """Max-aggregate per-frame class scores at their displaced positions.

    probs: (B, T, C) softmaxed scores; displ: (B, T) predicted signed offsets.
    For each t, target = clip(t - round(displ[t]), 0, T-1) and
    out[target] = max(out[target], probs[t]); positions no frame targets
    stay 0 (ref: model/modules.py:406-414). torch.round rounds half to even,
    as jnp.round does.
    """
    b, t, c = probs.shape
    pos = torch.arange(t, device=probs.device)
    tgt = (pos[None, :] - torch.round(displ).long()).clamp(0, t - 1)
    out = torch.zeros_like(probs)
    return out.scatter_reduce(
        1, tgt[..., None].expand(b, t, c), probs, reduce="amax", include_self=True
    )
