"""Bounding-box coordinate transforms (counterpart of
``lightning_pose_tpu/data/bboxes.py``).

Three coordinate spaces: **frame** (original pixels), **norm** ([0, 1]
relative to the bbox) and **model** (pixels of the resized model input).
Bboxes are ``[x, y, h, w]``.
"""

from __future__ import annotations

import torch

__all__ = ["model_to_norm", "norm_to_frame", "model_to_frame_batch"]


def _maybe_trim_context(keypoints: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """Drop the first and last 2 bbox rows when the keypoint batch is a
    context batch, 4 shorter than its bboxes (reference bboxes.py:64-68)."""
    if keypoints.shape[0] == bbox.shape[0]:
        return bbox
    return bbox[2:-2]


def model_to_norm(
    keypoints: torch.Tensor, model_width: float, model_height: float
) -> torch.Tensor:
    """model -> norm; keypoints ``(..., 2)``."""
    scale = torch.tensor(
        [model_width, model_height], dtype=keypoints.dtype, device=keypoints.device
    )
    return keypoints / scale


def norm_to_frame(keypoints: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """norm -> frame. keypoints ``(B, K, 2)``, bbox ``(B, 4)`` as [x, y, h, w]."""
    bbox = _maybe_trim_context(keypoints, bbox)
    x = keypoints[:, :, 0] * bbox[:, 3:4] + bbox[:, 0:1]
    y = keypoints[:, :, 1] * bbox[:, 2:3] + bbox[:, 1:2]
    return torch.stack([x, y], dim=-1)


def model_to_frame_batch(
    model_keypoints: torch.Tensor,
    bbox: torch.Tensor,
    model_width: float,
    model_height: float,
) -> torch.Tensor:
    """model -> frame over a flat ``(B, 2K)`` layout, single view
    (reference bboxes.py:220)."""
    num_targets = model_keypoints.shape[1]
    kp = model_to_norm(model_keypoints.reshape(-1, num_targets // 2, 2), model_width, model_height)
    return norm_to_frame(kp, bbox).reshape(-1, num_targets)
