"""Prediction heads (port of tdeed_tpu/models/heads.py:FCLayers; the FC2
double head waits, see ROADMAP.md)."""

from __future__ import annotations

from typing import Optional

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
