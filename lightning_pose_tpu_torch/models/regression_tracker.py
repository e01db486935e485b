"""Regression tracker: backbone + linear head -> direct (x, y) coordinates
(counterpart of ``lightning_pose_tpu/models/regression_tracker.py``)."""

from __future__ import annotations

import torch
from torch import nn

from lightning_pose_tpu_torch.models.backbones.factory import build_backbone
from lightning_pose_tpu_torch.models.heads.regression import LinearRegressionHead

__all__ = ["RegressionTracker"]


class RegressionTracker(nn.Module):
    """Normalized images ``(B, 3, H, W)`` -> keypoints ``(B, 2K)`` in model
    pixels, float32. There are no maps and no decode: every confidence is
    1."""

    def __init__(self, backbone_arch: str = "resnet50", num_keypoints: int = 17) -> None:
        super().__init__()
        if backbone_arch.startswith("vit"):
            # as the JAX package (and the reference): no ViT backbones
            raise NotImplementedError("regression models do not support ViT backbones")
        self.num_keypoints = num_keypoints
        self.backbone, num_features = build_backbone(backbone_arch, model_type="regression")
        self.head = LinearRegressionHead(num_features, 2 * num_keypoints)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(images))

    @staticmethod
    def confidences(keypoints: torch.Tensor) -> torch.Tensor:
        """The ``(B, K)`` confidences of ``(B, 2K)`` keypoints: ones."""
        return torch.ones(keypoints.shape[0], keypoints.shape[1] // 2, dtype=torch.float32, device=keypoints.device)
