"""Heatmap evaluation (counterpart of ``lightning_pose_tpu/data/heatmaps.py``).

Heatmaps are ``(B, K, H, W)``, the port's layout; the reference's are
``(B, H, W, K)``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["evaluate_heatmaps_at_location"]


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
