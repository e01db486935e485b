"""Bicubic resize of position embeddings (counterpart of
``lightning_pose_tpu/ops/interpolate.py``).

The JAX package writes torch's cubic convolution (a = -0.75, indices
clamped at the edges, no antialiasing) as a pair of 1-D matrices so that it
runs as two matmuls; here it is ``F.interpolate(mode="bicubic")`` itself.
The decode's upsample is a different operator (``jax.image.resize``'s
a = -0.5, taps outside the input dropped; ``ops/decode_kernel.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["bicubic_resize_2d"]


def bicubic_resize_2d(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bicubic resize (half-pixel centres) of the last two axes of ``(N, C,
    H, W)`` ``x`` to ``out_hw``, computed in float32 (float64 for float64
    input) and cast back to ``x``'s type."""
    if tuple(x.shape[-2:]) == tuple(out_hw):
        return x
    y = F.interpolate(
        x.to(torch.promote_types(x.dtype, torch.float32)), size=tuple(out_hw), mode="bicubic", align_corners=False
    )
    return y.to(x.dtype)
