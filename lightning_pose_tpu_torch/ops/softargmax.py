"""Soft-argmax decode (counterpart of ``lightning_pose_tpu/ops/softargmax.py``).

Upsample the predicted heatmaps 2x per downsample level (bicubic + 5x5
pyramid blur, one separable linear operator), sharpen with a temperature-1000
spatial softmax, take the spatial expectation, pool confidence in a window
around it, and correct the constant grid offset. Heatmaps are
``(B, K, H, W)``.
"""

from __future__ import annotations

import torch

__all__ = ["spatial_softmax2d", "spatial_expectation2d", "run_subpixelmaxima"]


def spatial_softmax2d(heatmaps: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Softmax over the spatial dims of each ``(B, K, H, W)`` map, in float32."""
    b, k, h, w = heatmaps.shape
    flat = heatmaps.to(torch.float32).reshape(b, k, h * w) * temperature
    return torch.softmax(flat, dim=-1).reshape(b, k, h, w)


def spatial_expectation2d(heatmaps: torch.Tensor) -> torch.Tensor:
    """Expected (x, y) pixel coordinates of normalized ``(B, K, H, W)`` maps;
    returns ``(B, K, 2)``."""
    h, w = heatmaps.shape[-2:]
    xs = torch.arange(w, dtype=heatmaps.dtype, device=heatmaps.device)
    ys = torch.arange(h, dtype=heatmaps.dtype, device=heatmaps.device)
    exp_x = torch.einsum("bkhw,w->bk", heatmaps, xs)
    exp_y = torch.einsum("bkhw,h->bk", heatmaps, ys)
    return torch.stack([exp_x, exp_y], dim=-1)


def run_subpixelmaxima(
    heatmaps: torch.Tensor,
    downsample_factor: int = 2,
    temperature: float = 1000.0,
    fast: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft-argmax decode of ``(B, K, h, w)`` heatmaps to ``(B, 2K)``
    keypoints in full-image pixels and ``(B, K)`` confidences.

    ``fast``: the fused decode (``ops/decode_kernel.decode``: the CUDA
    kernel on a CUDA tensor, inference only). Otherwise the plain,
    differentiable PyTorch path.
    """
    from lightning_pose_tpu_torch.ops import decode_kernel

    fn = decode_kernel.decode if fast else decode_kernel.decode_plain
    return fn(heatmaps, downsample_factor, temperature)
