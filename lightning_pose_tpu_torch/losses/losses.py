"""Supervised and unsupervised losses (counterpart of
``lightning_pose_tpu/losses/losses.py``).

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

from lightning_pose_tpu_torch.data.heatmaps import generate_heatmaps

__all__ = [
    "HeatmapJSLoss",
    "HeatmapKLLoss",
    "HeatmapLoss",
    "HeatmapMSELoss",
    "Loss",
    "PCALoss",
    "RegressionRMSELoss",
    "TemporalHeatmapLoss",
    "TemporalLoss",
    "UnimodalLoss",
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


def _js_div_2d(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Jensen-Shannon divergence of ``(B, K, h, w)`` maps -> ``(B, K)``."""
    m = 0.5 * (p + q)
    return 0.5 * _kl_div_2d(q, m) + 0.5 * _kl_div_2d(p, m)


class Loss:
    """Base class: weighting and epsilon rectification."""

    loss_name: str = "base"

    def __init__(self, epsilon: float | list[float] = 0.0, log_weight: float = 0.0, **kwargs: Any) -> None:
        # a list is one epsilon per keypoint
        self.epsilon = [float(e) for e in epsilon] if isinstance(epsilon, (list, tuple)) else float(epsilon)
        self.log_weight = float(log_weight)

    @property
    def weight(self) -> float:
        """``1 / (2 * exp(log_weight))``."""
        return 1.0 / (2.0 * math.exp(self.log_weight))

    def rectify_epsilon(self, loss: torch.Tensor) -> torch.Tensor:
        """Zero loss values below epsilon."""
        eps = self.epsilon
        if isinstance(eps, list):
            eps = torch.tensor(eps, dtype=loss.dtype, device=loss.device)
        return torch.relu(loss - eps)

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
        return _js_div_2d(predictions + _EPS, targets + _EPS)


class PCALoss(Loss):
    """Penalize predictions outside a low-dimensional subspace fitted to the
    labels (reference losses.py:418-565). Takes a fitted
    :class:`~lightning_pose_tpu_torch.utils.pca.KeypointPCA`; epsilon comes
    from the config or, if None, from the empirical percentile of the
    training reprojection error computed at fit time."""

    def __init__(
        self,
        loss_name: str,
        pca: Any,
        epsilon: float | None = None,
        empirical_epsilon_multiplier: float = 1.0,
        log_weight: float = 0.0,
        **kwargs: Any,
    ) -> None:
        if loss_name not in ("pca_singleview", "pca_multiview"):
            raise ValueError(f"Invalid loss_name: {loss_name}")
        if epsilon is None:
            epsilon = float(pca.parameters["epsilon"]) * empirical_epsilon_multiplier
        super().__init__(epsilon=epsilon, log_weight=log_weight)
        self.loss_name = loss_name
        self.pca = pca

    def __call__(
        self,
        keypoints_pred: torch.Tensor,
        stage: str | None = None,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """``keypoints_pred``: ``(B, 2K)`` flat (x, y)."""
        err = self.pca.reprojection_error_torch(self.pca.format_data_torch(keypoints_pred))
        rectified = self.rectify_epsilon(torch.nan_to_num(err, nan=0.0))
        scalar = masked_mean(rectified, ~torch.isnan(err))
        return scalar, self.log_loss(scalar, stage)


def _confident_pairs(confidences: torch.Tensor, prob_threshold: float) -> torch.Tensor:
    """``(B - 1, K)``: both frames of a consecutive pair are confident."""
    ok = confidences >= prob_threshold
    return ok[:-1] & ok[1:]


class TemporalLoss(Loss):
    """Norm of the frame-to-frame keypoint differences over a window
    (reference losses.py:568-695); pairs in which a frame's confidence is
    below ``prob_threshold`` count as 0."""

    loss_name = "temporal"

    def __init__(
        self,
        epsilon: float | list[float] = 0.0,
        prob_threshold: float = 0.0,
        log_weight: float = 0.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(epsilon=epsilon, log_weight=log_weight)
        self.prob_threshold = float(prob_threshold)

    def __call__(
        self,
        keypoints_pred: torch.Tensor,
        confidences: torch.Tensor | None = None,
        stage: str | None = None,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """``keypoints_pred (B, 2K)``; ``confidences (B, K)`` or None."""
        diffs = torch.diff(keypoints_pred, dim=0)
        diffs = diffs.reshape(diffs.shape[0], -1, 2)
        loss = torch.sqrt((diffs**2).sum(dim=2) + 1e-12)  # (B - 1, K)
        if confidences is not None:
            loss = torch.where(_confident_pairs(confidences, self.prob_threshold), loss, 0.0)
        scalar = self.rectify_epsilon(loss).mean()
        return scalar, self.log_loss(scalar, stage)


class TemporalHeatmapLoss(Loss):
    """Differences between consecutive frames' heatmaps, MSE or KL
    (reference losses.py:698-846)."""

    def __init__(
        self,
        loss_name: str,
        epsilon: float | list[float] = 0.0,
        prob_threshold: float = 0.0,
        log_weight: float = 0.0,
        **kwargs: Any,
    ) -> None:
        if loss_name not in ("temporal_heatmap_mse", "temporal_heatmap_kl"):
            raise ValueError(f"Invalid loss_name: {loss_name}")
        super().__init__(epsilon=epsilon, log_weight=log_weight)
        self.loss_name = loss_name
        self.prob_threshold = float(prob_threshold)

    def __call__(
        self,
        heatmaps_pred: torch.Tensor,
        confidences: torch.Tensor,
        stage: str | None = None,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """``heatmaps_pred (B, K, h, w)``; ``confidences (B, K)``."""
        prev, nxt = heatmaps_pred[:-1], heatmaps_pred[1:]
        if self.loss_name == "temporal_heatmap_mse":
            diffs = ((prev - nxt) ** 2).mean(dim=(2, 3))  # (B - 1, K)
        else:
            diffs = _kl_div_2d(prev + _EPS, nxt + _EPS)
        diffs = torch.where(_confident_pairs(confidences, self.prob_threshold), diffs, 0.0)
        scalar = self.rectify_epsilon(diffs).mean()
        return scalar, self.log_loss(scalar, stage)


class UnimodalLoss(Loss):
    """Penalize multimodal heatmaps against an ideal Gaussian at the
    predicted peak (reference losses.py:849-1004). Its keypoints are in
    augmented-image space, which the JAX package's train step does not pass
    (see ROADMAP queue 3); it is ported at class level."""

    def __init__(
        self,
        loss_name: str,
        original_image_height: int,
        original_image_width: int,
        downsampled_image_height: int,
        downsampled_image_width: int,
        prob_threshold: float = 0.0,
        log_weight: float = 0.0,
        **kwargs: Any,
    ) -> None:
        if loss_name not in ("unimodal_mse", "unimodal_kl", "unimodal_js"):
            raise ValueError(f"Invalid loss_name: {loss_name}")
        super().__init__(log_weight=log_weight)
        self.loss_name = loss_name
        self.original_image_height = int(original_image_height)
        self.original_image_width = int(original_image_width)
        self.downsampled_image_height = int(downsampled_image_height)
        self.downsampled_image_width = int(downsampled_image_width)
        self.prob_threshold = float(prob_threshold)

    def __call__(
        self,
        keypoints_pred_augmented: torch.Tensor,
        heatmaps_pred: torch.Tensor,
        confidences: torch.Tensor,
        stage: str | None = None,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Keypoints ``(B, 2K)`` in augmented-image space; heatmaps ``(B, K,
        h, w)``; confidences ``(B, K)``."""
        kp = keypoints_pred_augmented.reshape(keypoints_pred_augmented.shape[0], -1, 2)
        # the ideal heatmaps carry no gradient (reference losses.py:986)
        ideal = generate_heatmaps(
            kp.detach(),
            height=self.original_image_height,
            width=self.original_image_width,
            output_shape=(self.downsampled_image_height, self.downsampled_image_width),
        ).to(heatmaps_pred.dtype)
        valid = confidences >= self.prob_threshold  # (B, K)
        if self.loss_name == "unimodal_mse":
            elementwise, mask = (ideal - heatmaps_pred) ** 2, valid[..., None, None]
        elif self.loss_name == "unimodal_kl":
            elementwise, mask = _kl_div_2d(ideal + _EPS, heatmaps_pred + _EPS), valid
        else:
            elementwise, mask = _js_div_2d(heatmaps_pred + _EPS, ideal + _EPS), valid
        scalar = masked_mean(elementwise, mask)
        return scalar, self.log_loss(scalar, stage)


class RegressionMSELoss(Loss):
    """Mean squared error of the coordinates whose target is not NaN."""

    loss_name = "regression"

    def __call__(
        self,
        keypoints_targ: torch.Tensor,
        keypoints_pred: torch.Tensor,
        stage: str | None = None,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        mask = ~torch.isnan(keypoints_targ)
        sq = (torch.nan_to_num(keypoints_targ, nan=0.0) - keypoints_pred) ** 2
        scalar = masked_mean(sq, mask)
        return scalar, self.log_loss(scalar, stage)


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
