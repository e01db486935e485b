"""DARK decode (counterpart of ``lightning_pose_tpu/ops/dark.py``):
distribution-aware sub-pixel decoding (Zhang et al., "Distribution-Aware
Coordinate Representation for Human Pose Estimation", arXiv:1910.06278).

Each map is modulated by a separable Gaussian (zero padding, the map's
maximum kept), and the peak of the modulated map is refined by a
second-order Taylor expansion of its log, ``offset = -H^{-1} grad``, on the
3 x 3 stencil around the argmax (clamped inward; a peak on the border keeps
the raw argmax, with no offset). The keypoints come out at heatmap
resolution times ``2 ** downsample_factor``, with no upsampling. The
confidence is the mass of the normalized modulated map in the window
around the keypoint (``data/heatmaps.evaluate_heatmaps_at_location``).

This is ``cfg.eval.decode_method: dark``. It is plain PyTorch on either
device (the JAX package writes it in ``jnp`` too): the decode kernel does
not run on a DARK prediction.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from lightning_pose_tpu_torch.data.heatmaps import evaluate_heatmaps_at_location

__all__ = ["run_dark_decode"]

_EPS = 1e-10


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _modulate(heatmaps: torch.Tensor, sigma: float) -> torch.Tensor:
    """The separable Gaussian modulation of ``(B, K, H, W)`` maps, each map's
    maximum kept."""
    radius = max(1, int(round(3 * sigma)))
    k = torch.from_numpy(_gaussian_kernel1d(sigma, radius)).to(heatmaps.device, heatmaps.dtype)
    b, c, h, w = heatmaps.shape
    orig_max = heatmaps.amax(dim=(2, 3), keepdim=True)
    x = heatmaps.reshape(b * c, 1, h, w)
    x = F.conv2d(x, k.view(1, 1, -1, 1), padding=(radius, 0))
    x = F.conv2d(x, k.view(1, 1, 1, -1), padding=(0, radius)).reshape(b, c, h, w)
    new_max = x.amax(dim=(2, 3), keepdim=True)
    return x * orig_max / new_max.clamp_min(_EPS)


def run_dark_decode(
    heatmaps: torch.Tensor, downsample_factor: int = 2, sigma: float = 1.25
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode ``(B, K, H, W)`` heatmaps to ``(B, 2K)`` keypoints and ``(B, K)``
    confidences, float32, in full-image pixels. ``sigma`` is the training
    targets' Gaussian width (``data/heatmaps``: 1.25)."""
    heatmaps = heatmaps.float()
    b, k, h, w = heatmaps.shape
    hm = _modulate(heatmaps.clamp_min(0.0), sigma)
    hm_norm = hm / hm.sum(dim=(2, 3), keepdim=True).clamp_min(_EPS)
    log_hm = torch.log(hm.clamp_min(_EPS)).reshape(b, k, h * w)

    peak = hm.reshape(b, k, h * w).argmax(dim=-1)  # the first of equal maxima
    py, px = peak // w, peak % w
    offsets = torch.arange(-1, 2, device=heatmaps.device)
    ys = (py[..., None] + offsets).clamp(1, h - 2)  # the stencil kept inside the map
    xs = (px[..., None] + offsets).clamp(1, w - 2)
    index = (ys[..., :, None] * w + xs[..., None, :]).reshape(b, k, 9)
    patch = log_hm.gather(-1, index).reshape(b, k, 3, 3)

    dx = 0.5 * (patch[..., 1, 2] - patch[..., 1, 0])
    dy = 0.5 * (patch[..., 2, 1] - patch[..., 0, 1])
    dxx = patch[..., 1, 2] - 2.0 * patch[..., 1, 1] + patch[..., 1, 0]
    dyy = patch[..., 2, 1] - 2.0 * patch[..., 1, 1] + patch[..., 0, 1]
    dxy = 0.25 * (patch[..., 2, 2] - patch[..., 2, 0] - patch[..., 0, 2] + patch[..., 0, 0])
    det = dxx * dyy - dxy * dxy
    # the Taylor offset only where the stencil is centred on the peak
    interior = (py >= 1) & (py <= h - 2) & (px >= 1) & (px <= w - 2)
    safe = (det.abs() > _EPS) & interior
    det = torch.where(safe, det, torch.ones_like(det))
    zero = torch.zeros_like(det)
    off_x = torch.where(safe, (-(dyy * dx - dxy * dy) / det).clamp(-1.0, 1.0), zero)
    off_y = torch.where(safe, (-(dxx * dy - dxy * dx) / det).clamp(-1.0, 1.0), zero)

    coords = torch.stack([px.float() + off_x, py.float() + off_y], dim=-1)  # (B, K, 2)
    confidences = evaluate_heatmaps_at_location(hm_norm, coords)
    return (coords * float(2**downsample_factor)).reshape(b, 2 * k), confidences
