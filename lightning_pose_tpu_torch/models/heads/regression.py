"""Linear regression head: pooled features -> 2K coordinates (counterpart of
``lightning_pose_tpu/models/heads/regression.py``)."""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["LinearRegressionHead"]


class LinearRegressionHead(nn.Module):
    """Features ``(B, C)`` or ``(B, C, h, w)`` (averaged over h, w) ->
    ``Linear`` -> ``(B, num_targets)`` (x, y) coordinates, float32."""

    def __init__(self, in_features: int, num_targets: int) -> None:
        super().__init__()
        self.linear = nn.Linear(in_features, num_targets)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        if features.ndim == 4:
            features = features.mean(dim=(2, 3))
        return self.linear(features).float()
