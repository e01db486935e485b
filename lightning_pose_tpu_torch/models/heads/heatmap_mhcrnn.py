"""Multi-head CRNN head for 5-frame temporal context (counterpart of
``lightning_pose_tpu/models/heads/heatmap_mhcrnn.py``).

Two heads over per-frame backbone features:
- single-frame: the heatmap head on the middle frame;
- multi-frame: per-frame PixelShuffle and transposed convs up to heatmap
  resolution, then a bidirectional convolutional RNN
  (``x_f = W_f(x_t) + H_f(x_f)``) whose forward and backward final states
  are averaged, cast to float32 and given a temperature-1 spatial softmax.

The recurrence is a static 5-step unroll. The layers are cuDNN's
convolutions (the JAX package's are XLA convolutions, not Pallas kernels).
Every CRNN layer is Xavier-uniform with gain 1.0 on flax's fans of the HWIO
kernel (``fan_in = kh*kw*in/G``, ``fan_out = kh*kw*out``); the single-frame
head keeps its gain 0.01.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from lightning_pose_tpu_torch.models.heads.heatmap import HeatmapHead, SameConvTranspose2d, pixel_shuffle
from lightning_pose_tpu_torch.ops.softargmax import spatial_softmax2d

__all__ = [
    "GroupedConvTranspose2x2",
    "HeatmapMHCRNNHead",
    "UpsamplingCRNN",
    "grouped_deconv_kernel_from_flax",
    "grouped_deconv_kernel_to_flax",
]


def _xavier_uniform_flax_(weight: torch.Tensor, fan_in: int, fan_out: int, gain: float = 1.0) -> None:
    limit = gain * math.sqrt(6.0 / (fan_in + fan_out))
    nn.init.uniform_(weight, -limit, limit)


def grouped_deconv_kernel_from_flax(kernel: np.ndarray, groups: int) -> np.ndarray:
    """A :class:`GroupedConvTranspose2x2` kernel of the JAX package, HWIO
    ``(2, 2, in/G, out)``, as torch's ``(in, out/G, 2, 2)`` weight:
    ``W[g*(in/G) + i, o, a, b] = K[1-a, 1-b, i, g*(out/G) + o]``."""
    kh, kw, in_g, out = kernel.shape
    out_g = out // groups
    k = np.flip(kernel, (0, 1)).reshape(kh, kw, in_g, groups, out_g)
    return np.ascontiguousarray(k.transpose(3, 2, 4, 0, 1).reshape(groups * in_g, out_g, kh, kw))


def grouped_deconv_kernel_to_flax(weight: np.ndarray, groups: int) -> np.ndarray:
    """Inverse of :func:`grouped_deconv_kernel_from_flax`."""
    in_ch, out_g, kh, kw = weight.shape
    in_g = in_ch // groups
    k = weight.reshape(groups, in_g, out_g, kh, kw).transpose(3, 4, 1, 0, 2)
    return np.ascontiguousarray(np.flip(k.reshape(kh, kw, in_g, groups * out_g), (0, 1)))


class GroupedConvTranspose2x2(nn.ConvTranspose2d):
    """Grouped 2x2 stride-2 transposed conv, ``(B, in, n, m)`` ->
    ``(B, out, 2n, 2m)``: the JAX package's input-dilated grouped
    correlation, which is torch's transposed conv with the kernel flipped
    in both spatial axes (:func:`grouped_deconv_kernel_from_flax`)."""

    def __init__(self, in_channels: int, out_channels: int, groups: int) -> None:
        super().__init__(in_channels, out_channels, kernel_size=2, stride=2, padding=0, groups=groups)


class UpsamplingCRNN(nn.Module):
    """Bidirectional convolutional RNN over the context frames' upsampled
    features: ``(B, T, C, h, w)`` -> float32 heatmaps ``(B, K, 8h, 8w)``
    with ``upsampling_factor`` 2 (``4h`` with 1)."""

    def __init__(
        self,
        num_filters_for_upsampling: int,
        num_keypoints: int,
        upsampling_factor: int = 2,
        nfilters_channel: int = 16,
    ) -> None:
        super().__init__()
        k = num_keypoints
        channels = num_filters_for_upsampling // 4  # after PixelShuffle(2)
        self.upsampling_factor = upsampling_factor
        if upsampling_factor == 2:
            self.W_pre = SameConvTranspose2d(channels, k)
            channels = k
        self.W_f = SameConvTranspose2d(channels, k)
        self.W_b = SameConvTranspose2d(channels, k)
        hidden = k * nfilters_channel
        self.H_f_conv = nn.Conv2d(k, hidden, kernel_size=2, stride=2, groups=k)
        self.H_f_deconv = GroupedConvTranspose2x2(hidden, k, groups=k)
        self.H_b_conv = nn.Conv2d(k, hidden, kernel_size=2, stride=2, groups=k)
        self.H_b_deconv = GroupedConvTranspose2x2(hidden, k, groups=k)
        self.reset_like_flax()

    def reset_like_flax(self) -> None:
        """Xavier-uniform, gain 1.0, on flax's fans; biases zero."""
        with torch.no_grad():
            for layer in self.children():
                if isinstance(layer, nn.ConvTranspose2d):  # (in, out/G, kh, kw)
                    in_g = layer.in_channels // layer.groups
                    fan_in = in_g * math.prod(layer.kernel_size)
                    fan_out = layer.out_channels * math.prod(layer.kernel_size)
                else:  # Conv2d (out, in/G, kh, kw)
                    fan_in = layer.weight.shape[1] * math.prod(layer.kernel_size)
                    fan_out = layer.out_channels * math.prod(layer.kernel_size)
                _xavier_uniform_flax_(layer.weight, fan_in, fan_out)
                nn.init.zeros_(layer.bias)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        b, t = features.shape[:2]
        x = pixel_shuffle(features.reshape(b * t, *features.shape[2:]), 2)
        if self.upsampling_factor == 2:
            x = self.W_pre(x)
        # W_f and W_b of every frame do not depend on the recurrence: one
        # batched conv each
        wf = self.W_f(x).reshape(b, t, -1, 2 * x.shape[-2], 2 * x.shape[-1])
        wb = self.W_b(x).reshape(b, t, -1, 2 * x.shape[-2], 2 * x.shape[-1])
        x_f = wf[:, 0]
        for i in range(1, t):
            x_f = wf[:, i] + self.H_f_deconv(self.H_f_conv(x_f))
        x_b = wb[:, t - 1]
        for i in range(t - 2, -1, -1):
            x_b = wb[:, i] + self.H_b_deconv(self.H_b_conv(x_b))
        heatmaps = ((x_f + x_b) / 2).to(torch.promote_types(x_f.dtype, torch.float32))
        return spatial_softmax2d(heatmaps, temperature=1.0)


class HeatmapMHCRNNHead(nn.Module):
    """Single-frame and multi-frame heads: backbone features
    ``(B, T=5, C, h, w)`` -> ``(heatmaps_sf, heatmaps_mf)``, each
    ``(B, K, H', W')`` float32; the single-frame head reads frame 2."""

    def __init__(
        self,
        backbone_arch: str,
        in_channels: int,
        out_channels: int,
        downsample_factor: int = 2,
        upsampling_factor: int = 2,
    ) -> None:
        super().__init__()
        self.head_sf = HeatmapHead(
            backbone_arch=backbone_arch,
            in_channels=in_channels,
            out_channels=out_channels,
            downsample_factor=downsample_factor,
        )
        self.head_mf = UpsamplingCRNN(
            num_filters_for_upsampling=in_channels,
            num_keypoints=out_channels,
            upsampling_factor=upsampling_factor,
        )

    def forward(self, features: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return self.head_sf(features[:, 2]), self.head_mf(features)
