"""Temporal-context tracker, MHCRNN (counterpart of
``lightning_pose_tpu/models/heatmap_tracker_mhcrnn.py``).

The labeled forward takes 5-frame context stacks. A video sequence is tiled
into sliding 5-frame windows by :func:`make_context_windows`. Training
doubles the batch with the single-frame and multi-frame heads' maps;
prediction keeps, per keypoint, the head of higher confidence
(:func:`merge_heads_by_confidence`). Multiview context stacks ``(B, V, 5,
3, H, W)`` fold their views into the batch and unfold into view-major
channels (:func:`unfold_view_channels`).
"""

from __future__ import annotations

import torch
from torch import nn

from lightning_pose_tpu_torch.models.backbones.factory import build_backbone
from lightning_pose_tpu_torch.models.heads.heatmap_mhcrnn import HeatmapMHCRNNHead
from lightning_pose_tpu_torch.ops.softargmax import run_subpixelmaxima

__all__ = [
    "CONTEXT_FRAMES",
    "HeatmapTrackerMHCRNN",
    "make_context_windows",
    "merge_heads_by_confidence",
    "repeat_center_stack",
    "unfold_view_channels",
]

# the window length; the center frame is index 2
CONTEXT_FRAMES = 5


def make_context_windows(frames: torch.Tensor, repeat_center: bool = False) -> torch.Tensor:
    """Tile a ``(T, ...)`` sequence into ``(T-4, 5, ...)`` sliding windows;
    the first and last two frames are never a center. ``repeat_center``
    fills each window with 5 copies of its center frame instead (what a
    model trained with ``model.mhcrnn_context_mode=repeat_center`` saw)."""
    t = frames.shape[0]
    if t < CONTEXT_FRAMES:
        raise ValueError(f"context windows need at least 5 frames, got a sequence of {t}")
    if repeat_center:
        return frames[2:t - 2, None].expand(t - 4, CONTEXT_FRAMES, *frames.shape[1:])
    idx = torch.arange(t - 4, device=frames.device)[:, None] + torch.arange(CONTEXT_FRAMES, device=frames.device)
    return frames[idx]


def repeat_center_stack(stacks: torch.Tensor, time_axis: int) -> torch.Tensor:
    """5 copies of each window's center frame along ``time_axis``."""
    center = stacks.narrow(time_axis, 2, 1)
    sizes = list(stacks.shape)
    sizes[time_axis] = CONTEXT_FRAMES
    return center.expand(*sizes)


def merge_heads_by_confidence(
    kp_sf: torch.Tensor, conf_sf: torch.Tensor, kp_mf: torch.Tensor, conf_mf: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per keypoint, the multi-frame head's ``(x, y)`` where its confidence
    is at least the single-frame head's, else the single-frame head's;
    the confidence is the larger one. Keypoints ``(B, 2K)``, confidences
    ``(B, K)``."""
    take_mf = conf_mf >= conf_sf
    kp_sf2 = kp_sf.reshape(kp_sf.shape[0], -1, 2)
    kp_mf2 = kp_mf.reshape(kp_mf.shape[0], -1, 2)
    kp = torch.where(take_mf[..., None], kp_mf2, kp_sf2)
    return kp.reshape(kp_sf.shape), torch.maximum(conf_sf, conf_mf)


def unfold_view_channels(heatmaps: torch.Tensor, b: int, v: int) -> torch.Tensor:
    """``(B*V, K, h, w)`` maps of views folded into the batch -> ``(B, V*K,
    h, w)``, view-major channels (the multiview datasets' keypoint order)."""
    _, k, h, w = heatmaps.shape
    return heatmaps.reshape(b, v * k, h, w)


class HeatmapTrackerMHCRNN(nn.Module):
    """Normalized context stacks ``(B, 5, 3, H, W)`` -> ``(heatmaps_sf,
    heatmaps_mf)``, each ``(B, K, H/4, W/4)`` float32. Multiview stacks
    ``(B, V, 5, 3, H, W)`` fold their views into the batch, and both heads'
    maps unfold into ``(B, V*K, H/4, W/4)``.

    ``context_repeat`` (``model.mhcrnn_context_mode=repeat_center``): the
    stacks are 5 copies of their center, so the backbone encodes the center
    once and its features are tiled over the 5 steps. The heads see the
    same input, and BatchNorm the same batch statistics, since repeating
    samples changes neither the mean nor the biased variance.
    """

    def __init__(
        self,
        backbone_arch: str = "resnet50",
        num_keypoints: int = 17,
        downsample_factor: int = 2,
        context_repeat: bool = False,
        image_size: int = 256,
    ) -> None:
        super().__init__()
        if downsample_factor != 2:
            raise ValueError("heatmap_mhcrnn only supports downsample_factor=2")
        self.downsample_factor = downsample_factor
        self.context_repeat = context_repeat
        self.backbone, num_features = build_backbone(backbone_arch, model_type="heatmap", image_size=image_size)
        self.head = HeatmapMHCRNNHead(
            backbone_arch=backbone_arch,
            in_channels=num_features,
            out_channels=num_keypoints,
            downsample_factor=downsample_factor,
        )

    def forward(self, images: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if images.ndim == 6:
            b, v = images.shape[:2]
            hm_sf, hm_mf = self(images.reshape(b * v, *images.shape[2:]))
            return unfold_view_channels(hm_sf, b, v), unfold_view_channels(hm_mf, b, v)
        if images.ndim != 5:
            raise ValueError(
                f"the context model takes (B, 5, 3, H, W) or (B, V, 5, 3, H, W) stacks, got {tuple(images.shape)}"
            )
        b, t = images.shape[:2]
        if self.context_repeat:
            features = self.backbone(images[:, t // 2])
            features = features[:, None].expand(b, t, *features.shape[1:])
        else:
            features = self.backbone(images.reshape(b * t, *images.shape[2:]))
            features = features.reshape(b, t, *features.shape[1:])
        return self.head(features)

    def decode(self, heatmaps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Soft-argmax decode of one head's maps to ``(B, 2K)`` keypoints and
        ``(B, K)`` confidences (the decode kernel on a CUDA tensor)."""
        return run_subpixelmaxima(heatmaps, downsample_factor=self.downsample_factor, temperature=1000.0)

    def decode_heads(self, heatmaps: tuple[torch.Tensor, torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
        """Both heads' maps decoded (two decode launches) and merged per
        keypoint by confidence (:func:`merge_heads_by_confidence`)."""
        hm_sf, hm_mf = heatmaps
        return merge_heads_by_confidence(*self.decode(hm_sf), *self.decode(hm_mf))
