"""The reference's frames: every frame of an mp4 decoded in order with
OpenCV, converted to RGB and resized bilinearly to the model's input size
(half-pixel centres, edges clamped, rounded half up), as Lightning Pose's
video pipeline resizes them."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["read_frames", "resize_bilinear"]


def read_frames(path) -> np.ndarray:
    """``(N, H, W, 3)`` uint8 RGB frames of the video at ``path``."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"no frames decoded from {path}")
    return np.stack(frames)


def _taps(src: int, dst: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    scale = torch.tensor(src, dtype=torch.float32) / dst
    f = ((torch.arange(dst, dtype=torch.float32) + 0.5) * scale - 0.5).clamp(0.0, src - 1.0)
    lo = f.to(torch.int64)
    return lo.to(device), (lo + 1).clamp(max=src - 1).to(device), (f - lo).to(device)


def resize_bilinear(frames: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``(N, h, w, 3)`` uint8 -> ``(N, height, width, 3)`` uint8, float32
    arithmetic."""
    y0, y1, wy = _taps(frames.shape[1], height, frames.device)
    x0, x1, wx = _taps(frames.shape[2], width, frames.device)
    x = frames.to(torch.float32)
    r0, r1 = x[:, y0], x[:, y1]
    wy, wx = wy[None, :, None, None], wx[None, None, :, None]
    v = ((1 - wy) * (1 - wx)) * r0[:, :, x0] + ((1 - wy) * wx) * r0[:, :, x1] \
        + (wy * (1 - wx)) * r1[:, :, x0] + (wy * wx) * r1[:, :, x1]
    return (v + 0.5).to(torch.uint8)
