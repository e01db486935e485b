"""Bounding-box coordinate transforms (counterpart of
``lightning_pose_tpu/data/bboxes.py``).

Three coordinate spaces: **frame** (original pixels), **norm** ([0, 1]
relative to the bbox) and **model** (pixels of the resized model input).
Bboxes are ``[x, y, h, w]``.
"""

from __future__ import annotations

import torch

__all__ = [
    "frame_to_model_batch",
    "frame_to_model_matrices",
    "frame_to_norm",
    "model_to_frame_batch",
    "model_to_norm",
    "norm_to_frame",
    "norm_to_model",
]


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


def norm_to_model(
    keypoints: torch.Tensor, model_width: float, model_height: float
) -> torch.Tensor:
    """norm -> model; keypoints ``(..., 2)``."""
    scale = torch.tensor(
        [model_width, model_height], dtype=keypoints.dtype, device=keypoints.device
    )
    return keypoints * scale


def frame_to_norm(keypoints: torch.Tensor, bbox: torch.Tensor) -> torch.Tensor:
    """frame -> norm. keypoints ``(B, K, 2)``, bbox ``(B, 4)`` as [x, y, h, w]."""
    bbox = _maybe_trim_context(keypoints, bbox)
    x = (keypoints[:, :, 0] - bbox[:, 0:1]) / bbox[:, 3:4]
    y = (keypoints[:, :, 1] - bbox[:, 1:2]) / bbox[:, 2:3]
    return torch.stack([x, y], dim=-1)


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
    num_views: int = 1,
) -> torch.Tensor:
    """model -> frame over a flat ``(B, 2K)`` layout (reference
    bboxes.py:220). With ``num_views > 1`` the keypoints are view-major, K/V
    per view, and ``bbox`` is ``(B, 4 * num_views)``: view ``v`` maps through
    columns ``[4v, 4v + 4)``."""
    num_targets = model_keypoints.shape[1]
    num_keypoints = num_targets // 2
    kp = model_to_norm(model_keypoints.reshape(-1, num_keypoints, 2), model_width, model_height)
    if num_views > 1:
        per_view = num_keypoints // num_views
        bbox = _maybe_trim_context(kp, bbox)
        kp = norm_to_frame(kp.reshape(-1, per_view, 2), bbox.reshape(-1, 4))
    else:
        kp = norm_to_frame(kp, bbox)
    return kp.reshape(-1, num_targets)


def frame_to_model_batch(
    frame_keypoints: torch.Tensor,
    bbox: torch.Tensor,
    model_width: float,
    model_height: float,
) -> torch.Tensor:
    """Multiview frame -> model (reference bboxes.py:192): keypoints ``(B,
    V, K, 2)``, ``bbox (B, 4V)``, view ``v`` through columns ``[4v, 4v +
    4)``; returns ``(B, V, K, 2)``. Differentiable in the keypoints."""
    b, v, k, _ = frame_keypoints.shape
    norm = frame_to_norm(frame_keypoints.reshape(b * v, k, 2), bbox.reshape(b * v, 4))
    return norm_to_model(norm, model_width, model_height).reshape(b, v, k, 2)


def frame_to_model_matrices(bbox: torch.Tensor, model_width: float, model_height: float) -> torch.Tensor:
    """``(B, V, 3, 3)`` affines from each view's frame pixels to model
    pixels, from ``bbox (B, 4V)`` ``[x, y, h, w]`` a view: what
    :func:`frame_to_model_batch` computes, as matrices."""
    b = bbox.shape[0]
    boxes = bbox.reshape(b, -1, 4)
    sx, sy = model_width / boxes[..., 3], model_height / boxes[..., 2]
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    return torch.stack([
        torch.stack([sx, zeros, -boxes[..., 0] * sx], dim=-1),
        torch.stack([zeros, sy, -boxes[..., 1] * sy], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
