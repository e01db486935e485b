"""Gaussian target heatmaps and their evaluation (counterpart of
``lightning_pose_tpu/data/heatmaps.py``).

Heatmaps are ``(B, K, H, W)``, the port's layout; the reference's are
``(B, H, W, K)``. Visibility semantics: 0 gives a zero map (ignored by the
losses), 1 a uniform map, 2 a Gaussian; NaN or out-of-range keypoints give a
zero map.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["evaluate_heatmaps_at_location", "generate_heatmaps"]


def generate_heatmaps(
    keypoints: torch.Tensor,
    height: int,
    width: int,
    output_shape: tuple[int, int],
    sigma: float = 1.25,
    visibility: torch.Tensor | None = None,
) -> torch.Tensor:
    """2D Gaussian target heatmaps, each normalised to sum to 1.

    Args:
        keypoints: ``(B, K, 2)`` (x, y) in input-image pixels.
        height, width: input image size in pixels.
        output_shape: ``(h, w)`` of the heatmaps.
        sigma: Gaussian std in heatmap pixels.
        visibility: optional ``(B, K)`` integer flags 0/1/2.

    Returns:
        ``(B, K, h, w)`` float32.
    """
    out_height, out_width = output_shape
    keypoints = keypoints.to(torch.float32)
    x = keypoints[:, :, 0] * (out_width / width)
    y = keypoints[:, :, 1] * (out_height / height)
    lost = torch.isnan(x) | (x < -1) | (x > out_width + 1) | (y < -1) | (y > out_height + 1)
    # clamp to keep the exponent finite (NaN becomes the lower bound)
    x = torch.nan_to_num(x, nan=-1.0).clamp(-1, out_width + 1)
    y = torch.nan_to_num(y, nan=-1.0).clamp(-1, out_height + 1)
    yy = torch.arange(out_height, dtype=torch.float32, device=keypoints.device)[:, None]
    xx = torch.arange(out_width, dtype=torch.float32, device=keypoints.device)[None, :]
    log_g = -((yy - y[..., None, None]) ** 2 + (xx - x[..., None, None]) ** 2) / (2.0 * sigma**2)
    heatmaps = torch.exp(log_g)
    heatmaps = heatmaps / heatmaps.sum(dim=(2, 3), keepdim=True)
    heatmaps = torch.where(lost[..., None, None], 0.0, heatmaps)
    if visibility is not None:
        vis = visibility[..., None, None]
        heatmaps = torch.where(vis == 1, 1.0 / (out_height * out_width), heatmaps)
        heatmaps = torch.where(vis == 0, 0.0, heatmaps)
    return heatmaps


def evaluate_heatmaps_at_location(
    heatmaps: torch.Tensor,
    locs: torch.Tensor,
    sigma: float = 1.25,
    num_stds: int = 2,
) -> torch.Tensor:
    """Sum of heatmap mass in the ``(2p+1)^2`` window, ``p = floor(sigma *
    num_stds)``, around each location truncated to int and clipped to the
    map; the map is zero outside its bounds.

    Args:
        heatmaps: ``(B, K, H, W)``.
        locs: ``(B, K, 2)`` (x, y) locations.

    Returns:
        ``(B, K)`` confidences.
    """
    pix = int(math.floor(sigma * num_stds))
    b, k, h, w = heatmaps.shape
    # truncate toward zero like the reference's int cast; no gradient
    # flows through the indices
    locs = locs.detach()
    xi = locs[..., 0].to(torch.int64).clamp(0, w - 1)
    yi = locs[..., 1].to(torch.int64).clamp(0, h - 1)
    padded = F.pad(heatmaps, (pix, pix, pix, pix))
    offsets = torch.arange(2 * pix + 1, device=heatmaps.device)
    rows = (yi[..., None] + offsets)[..., :, None]  # (B, K, win, 1), padded coords
    cols = (xi[..., None] + offsets)[..., None, :]  # (B, K, 1, win)
    b_idx = torch.arange(b, device=heatmaps.device)[:, None, None, None]
    k_idx = torch.arange(k, device=heatmaps.device)[None, :, None, None]
    return padded[b_idx, k_idx, rows, cols].sum(dim=(-2, -1))
