"""Heatmap head: PixelShuffle + transposed-conv upsampling + spatial softmax
(counterpart of ``lightning_pose_tpu/models/heads/heatmap.py``).

A PixelShuffle(2), then ``log2(stride) - downsample_factor - 1`` transposed
convs (3x3, stride 2), then a temperature-1 spatial softmax. Weights are
Xavier-uniform with gain 0.01, biases zero.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lightning_pose_tpu_torch.models.backbones.factory import BACKBONE_STRIDES
from lightning_pose_tpu_torch.ops.softargmax import spatial_softmax2d

__all__ = ["HeatmapHead", "SameConvTranspose2d", "pixel_shuffle"]


def pixel_shuffle(x: torch.Tensor, upscale: int = 2) -> torch.Tensor:
    """``(B, C, H, W)`` -> ``(B, C/r^2, rH, rW)``; channel ``c*r^2 + i*r + j``
    feeds spatial offset ``(i, j)``, as in the reference's NHWC version."""
    return F.pixel_shuffle(x, upscale)


class SameConvTranspose2d(nn.ConvTranspose2d):
    """3x3 stride-2 transposed conv with the output of flax's
    ``nn.ConvTranspose(padding="SAME")``: ``(B, C, n, m)`` -> ``(B, C', 2n, 2m)``.

    That is torch's transposed conv with no padding, cropped to the first
    ``2n`` rows and ``2m`` columns. The weight is torch's ``(in, out, kh,
    kw)``; a flax kernel maps to it flipped in both spatial axes (see
    ``train/checkpoints.py``). ``padding=1, output_padding=1`` is a
    different operator.
    """

    def __init__(self, in_channels: int, out_channels: int) -> None:
        super().__init__(in_channels, out_channels, kernel_size=3, stride=2, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, m = x.shape[-2:]
        return super().forward(x)[..., : 2 * n, : 2 * m]


class HeatmapHead(nn.Module):
    """Backbone features ``(B, C, h, w)`` -> per-keypoint heatmaps
    ``(B, K, h * 2^(n_layers+1), w * 2^(n_layers+1))``, float32."""

    def __init__(
        self,
        backbone_arch: str,
        in_channels: int,
        out_channels: int,
        downsample_factor: int = 2,
    ) -> None:
        super().__init__()
        stride = BACKBONE_STRIDES.get(backbone_arch, 32)
        self.n_layers = int(math.log2(stride)) - downsample_factor - 1
        channels = in_channels // 4  # after PixelShuffle(2)
        for layer in range(self.n_layers):
            deconv = SameConvTranspose2d(channels, out_channels)
            nn.init.xavier_uniform_(deconv.weight, gain=0.01)
            nn.init.zeros_(deconv.bias)
            setattr(self, f"deconv{layer}", deconv)
            channels = out_channels

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = pixel_shuffle(features, 2)
        for layer in range(self.n_layers):
            x = getattr(self, f"deconv{layer}")(x)
        return spatial_softmax2d(x, temperature=1.0)
