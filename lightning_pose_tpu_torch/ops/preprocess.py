"""uint8 frames -> ImageNet-normalized float, batched on the device
(counterpart of ``lightning_pose_tpu/ops/preprocess.py``)."""

from __future__ import annotations

import torch

__all__ = [
    "normalize_images",
    "normalize_images_fused",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images: torch.Tensor) -> torch.Tensor:
    """uint8/float pixel images ``(..., H, W, 3)`` -> ImageNet-normalized
    float32, same layout."""
    x = images.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=images.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=images.device)
    return (x - mean) / std


def normalize_images_fused(
    images_uint8: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 ``(..., H, W, 3)`` frames -> normalized ``(..., 3, H, W)`` in
    ``out_dtype``, stored channels-last so the first convolution takes it
    without a copy. On a CUDA tensor this is the Triton normalize kernel
    (``ops/normalize_kernel.py``)."""
    from lightning_pose_tpu_torch.ops.normalize_kernel import normalize

    return normalize(images_uint8, out_dtype=out_dtype)
