"""Heatmap tracker: backbone + heatmap head, single-frame (counterpart of
``lightning_pose_tpu/models/heatmap_tracker.py``). Any backbone name: a
convnet or a transformer, whose token grid the head takes as a feature
map (stride 16, or 32 for the SAM2 Hiera trunks). On multiview data the
views fold into the batch and the maps unfold into view-major channels."""

from __future__ import annotations

import torch
from torch import nn

from lightning_pose_tpu_torch.models.backbones.factory import build_backbone
from lightning_pose_tpu_torch.models.heads.heatmap import HeatmapHead
from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import unfold_view_channels
from lightning_pose_tpu_torch.ops.softargmax import run_subpixelmaxima

__all__ = ["HeatmapTracker"]


class HeatmapTracker(nn.Module):
    """Normalized images ``(B, 3, H, W)`` -> heatmaps
    ``(B, K, H/2^df, W/2^df)``, float32; multiview images ``(B, V, 3, H,
    W)`` -> ``(B, V*K, H/2^df, W/2^df)``, each view through the same trunk
    and head."""

    def __init__(
        self,
        backbone_arch: str = "resnet50",
        num_keypoints: int = 17,
        downsample_factor: int = 2,
        image_size: int = 256,
    ) -> None:
        super().__init__()
        self.downsample_factor = downsample_factor
        self.backbone, num_features = build_backbone(backbone_arch, model_type="heatmap", image_size=image_size)
        self.head = HeatmapHead(
            backbone_arch=backbone_arch,
            in_channels=num_features,
            out_channels=num_keypoints,
            downsample_factor=downsample_factor,
        )

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        if images.ndim == 5:
            b, v = images.shape[:2]
            return unfold_view_channels(self(images.reshape(b * v, *images.shape[2:])), b, v)
        return self.head(self.backbone(images))

    def decode(self, heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Soft-argmax decode to ``(B, 2K)`` keypoints and ``(B, K)``
        confidences (the decode kernel on a CUDA tensor)."""
        return run_subpixelmaxima(
            heatmaps,
            downsample_factor=self.downsample_factor,
            temperature=1000.0,
        )
