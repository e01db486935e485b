"""Supervised losses (counterpart of ``lightning_pose_tpu/losses/losses.py``).

Each loss is a masked fixed-shape computation: invalid entries add nothing
to the numerator and are left out of the denominator. The weight is the
reference's ``1 / (2 * exp(log_weight))``. Heatmaps are ``(B, K, h, w)``.
Losses hold only their hyperparameters; ``__call__`` returns
``(scalar loss, logs)`` with the logs as 0-d tensors, so nothing waits for
the device until a caller reads them.
"""

from __future__ import annotations

import math
from typing import Any

import torch

__all__ = [
    "HeatmapJSLoss",
    "HeatmapKLLoss",
    "HeatmapLoss",
    "HeatmapMSELoss",
    "Loss",
    "RegressionRMSELoss",
    "masked_mean",
]

_EPS = 1e-10


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` where ``mask`` is true, 0 when nothing is valid;
    ``mask`` broadcasts against ``values`` and the denominator counts the
    broadcast elements."""
    mask = torch.broadcast_to(mask, values.shape)
    num = torch.where(mask, values, 0.0).sum()
    den = mask.to(values.dtype).sum()
    return torch.where(den > 0, num / den.clamp(min=1.0), 0.0)


def _kl_div_2d(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(p || q) over the spatial dims of ``(B, K, h, w)`` maps -> ``(B, K)``."""
    return (p * (torch.log(p) - torch.log(q))).sum(dim=(2, 3))


class Loss:
    """Base class: weighting and epsilon rectification."""

    loss_name: str = "base"

    def __init__(self, epsilon: float = 0.0, log_weight: float = 0.0, **kwargs: Any) -> None:
        self.epsilon = float(epsilon)
        self.log_weight = float(log_weight)

    @property
    def weight(self) -> float:
        """``1 / (2 * exp(log_weight))``."""
        return 1.0 / (2.0 * math.exp(self.log_weight))

    def rectify_epsilon(self, loss: torch.Tensor) -> torch.Tensor:
        """Zero loss values below epsilon."""
        return torch.relu(loss - self.epsilon)

    def log_loss(self, loss: torch.Tensor, stage: str | None) -> dict[str, torch.Tensor]:
        return {
            f"{stage}_{self.loss_name}_loss": loss,
            f"{self.loss_name}_weight": torch.tensor(self.weight, dtype=torch.float32),
        }


class HeatmapLoss(Loss):
    """Base of the heatmap divergences; all-zero target maps are masked out."""

    def elementwise(self, targets: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(
        self,
        heatmaps_targ: torch.Tensor,
        heatmaps_pred: torch.Tensor,
        stage: str | None = None,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        valid = (heatmaps_targ != 0.0).any(dim=3).any(dim=2)  # (B, K)
        elementwise = self.elementwise(heatmaps_targ, heatmaps_pred)
        mask = valid[..., None, None] if elementwise.ndim == 4 else valid
        scalar = masked_mean(elementwise, mask)
        return scalar, self.log_loss(scalar, stage)


class HeatmapMSELoss(HeatmapLoss):
    """Pixel-wise squared error times ``h * w``."""

    loss_name = "heatmap_mse"

    def elementwise(self, targets: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
        h, w = targets.shape[2], targets.shape[3]
        return (targets - predictions) ** 2 * (h * w)


class HeatmapKLLoss(HeatmapLoss):
    """Per-keypoint KL(target || prediction)."""

    loss_name = "heatmap_kl"

    def elementwise(self, targets: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
        return _kl_div_2d(targets + _EPS, predictions + _EPS)


class HeatmapJSLoss(HeatmapLoss):
    """Per-keypoint Jensen-Shannon divergence."""

    loss_name = "heatmap_js"

    def elementwise(self, targets: torch.Tensor, predictions: torch.Tensor) -> torch.Tensor:
        pred, targ = predictions + _EPS, targets + _EPS
        m = 0.5 * (pred + targ)
        return 0.5 * _kl_div_2d(targ, m) + 0.5 * _kl_div_2d(pred, m)


class RegressionRMSELoss(Loss):
    """Per-keypoint Euclidean pixel error over the keypoints whose target is
    not NaN."""

    loss_name = "rmse"

    def __call__(
        self,
        keypoints_targ: torch.Tensor,
        keypoints_pred: torch.Tensor,
        stage: str | None = None,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        targ = keypoints_targ.reshape(-1, 2)
        pred = keypoints_pred.reshape(-1, 2)
        valid = ~torch.isnan(targ).any(dim=1)
        sq = torch.where(valid[:, None], (torch.nan_to_num(targ, nan=0.0) - pred) ** 2, 0.0)
        dist = torch.sqrt(sq.mean(dim=1) + 1e-12)
        scalar = masked_mean(dist, valid)
        return scalar, self.log_loss(scalar, stage)
