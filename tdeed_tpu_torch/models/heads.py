"""Prediction heads (port of tdeed_tpu/models/heads.py): FCLayers and the
FC2 double head of joint two-dataset training."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from tdeed_tpu_torch.models.common import Linear

DROPOUT_RATE = 0.5


class FCLayers(nn.Module):
    """Dropout(0.5) + Linear over the feature dim (ref: model/modules.py:366-376).

    The dropout mask is an input, drawn by the train step from its own
    generator: ``keep`` is a boolean tensor shaped like x, or None for no
    dropout (eval, or a deterministic train-mode forward)."""

    def __init__(self, in_features: int, num_classes: int):
        super().__init__()
        self._fc_out = Linear(in_features, num_classes)

    def forward(self, x, keep: Optional[torch.Tensor] = None):
        if keep is not None:
            x = torch.where(keep, x / (1.0 - DROPOUT_RATE), torch.zeros_like(x))
        return self._fc_out(x)


class FC2Layers(nn.Module):
    """Two FCLayers concatenated on the class axis, for joint two-dataset
    training (ref: model/modules.py:378-387): ``num_classes`` is (C1+1,
    C2+1), e.g. (13, 18) for SoccerNet Ball + SoccerNet. Each head takes
    its own dropout mask, ``keep1`` and ``keep2``."""

    def __init__(self, in_features: int, num_classes: Sequence[int]):
        super().__init__()
        self._fc1 = FCLayers(in_features, num_classes[0])
        self._fc2 = FCLayers(in_features, num_classes[1])

    def forward(self, x, keep1: Optional[torch.Tensor] = None,
                keep2: Optional[torch.Tensor] = None):
        return torch.cat([self._fc1(x, keep1), self._fc2(x, keep2)], dim=-1)
