"""Heatmap tracker: backbone + heatmap head, single-frame (counterpart of
``lightning_pose_tpu/models/heatmap_tracker.py``)."""

from __future__ import annotations

import torch
from torch import nn

from lightning_pose_tpu_torch.models.backbones.factory import build_backbone
from lightning_pose_tpu_torch.models.heads.heatmap import HeatmapHead
from lightning_pose_tpu_torch.ops.softargmax import run_subpixelmaxima

__all__ = ["HeatmapTracker"]


class HeatmapTracker(nn.Module):
    """Normalized images ``(B, 3, H, W)`` -> heatmaps
    ``(B, K, H/2^df, W/2^df)``, float32."""

    def __init__(
        self,
        backbone_arch: str = "resnet50",
        num_keypoints: int = 17,
        downsample_factor: int = 2,
    ) -> None:
        super().__init__()
        self.downsample_factor = downsample_factor
        self.backbone, num_features = build_backbone(backbone_arch, model_type="heatmap")
        self.head = HeatmapHead(
            backbone_arch=backbone_arch,
            in_channels=num_features,
            out_channels=num_keypoints,
            downsample_factor=downsample_factor,
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.backbone(images))

    def decode(
        self, heatmaps: torch.Tensor, fast: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Soft-argmax decode to ``(B, 2K)`` keypoints and ``(B, K)``
        confidences; ``fast`` takes the fused decode kernel."""
        return run_subpixelmaxima(
            heatmaps,
            downsample_factor=self.downsample_factor,
            temperature=1000.0,
            fast=fast,
        )
