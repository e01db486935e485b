"""Multiview transformer tracker (counterpart of
``lightning_pose_tpu/models/heatmap_tracker_multiview.py``).

Each view's patch tokens get a learned view embedding, the views are
concatenated into one sequence of ``V * N`` tokens so that attention runs
across views, and one heatmap head, shared by the views, decodes each
view's token grid. The backbone is a plain ViT, DINOv2 or DINOv3 (whose
RoPE tables are tiled once a view, with no prefix tokens in the
sequence). The maps come out view-major: channel ``v * K + k`` is
keypoint ``k`` of view ``v``, as the JAX model's last axis.
"""

from __future__ import annotations

import torch
from torch import nn

from lightning_pose_tpu_torch.models.backbones.factory import (
    ALLOWED_TRANSFORMER_BACKBONES_MULTIVIEW,
    make_transformer_module,
)
from lightning_pose_tpu_torch.models.heads.heatmap import HeatmapHead
from lightning_pose_tpu_torch.ops.softargmax import run_subpixelmaxima

__all__ = ["HeatmapTrackerMultiviewTransformer"]


class HeatmapTrackerMultiviewTransformer(nn.Module):
    """Normalized views ``(B, V, 3, H, W)`` -> heatmaps ``(B, V*K, H/2^df,
    W/2^df)``, float32."""

    def __init__(
        self,
        backbone_arch: str = "vits_dino",
        num_keypoints: int = 17,
        num_views: int = 2,
        downsample_factor: int = 2,
        image_size: int = 256,
    ) -> None:
        super().__init__()
        if backbone_arch not in ALLOWED_TRANSFORMER_BACKBONES_MULTIVIEW:
            raise ValueError(
                f'backbone "{backbone_arch}" is not supported for multiview transformer models; '
                f"allowed: {ALLOWED_TRANSFORMER_BACKBONES_MULTIVIEW}"
            )
        self.num_keypoints = num_keypoints
        self.num_views = num_views
        self.downsample_factor = downsample_factor
        self.backbone, embed_dim = make_transformer_module(backbone_arch, image_size)
        self.embed_dim = embed_dim
        self.view_embeddings = nn.Parameter(torch.zeros(num_views, embed_dim))
        self.head = HeatmapHead(
            backbone_arch=backbone_arch,
            in_channels=embed_dim,
            out_channels=num_keypoints,
            downsample_factor=downsample_factor,
        )

    def reset_like_flax(self) -> None:
        with torch.no_grad():
            nn.init.normal_(self.view_embeddings, std=0.02)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, v = images.shape[:2]
        if v != self.num_views:
            raise ValueError(f"the model has {self.num_views} views, the images {v}")
        tokens, (gh, gw) = self.backbone.embed(images.reshape(b * v, *images.shape[2:]))
        n, d = tokens.shape[1:]
        tokens = tokens.reshape(b, v, n, d) + self.view_embeddings[None, :, None, :]
        tokens = self.backbone.encode_tokens(tokens.reshape(b, v * n, d), grid=(gh, gw), num_views=v)
        feats = tokens.reshape(b * v, gh, gw, d).permute(0, 3, 1, 2)
        heatmaps = self.head(feats)
        return heatmaps.reshape(b, v * self.num_keypoints, *heatmaps.shape[-2:])

    def decode(self, heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Soft-argmax decode of all ``V*K`` maps to ``(B, 2VK)`` keypoints and
        ``(B, VK)`` confidences (the decode kernel on a CUDA tensor)."""
        return run_subpixelmaxima(heatmaps, downsample_factor=self.downsample_factor, temperature=1000.0)
