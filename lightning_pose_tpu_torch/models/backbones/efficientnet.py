"""EfficientNet B0-B2 backbones (counterpart of
``lightning_pose_tpu/models/backbones/efficientnet.py``).

The JAX module's architecture, not torchvision's: MBConv blocks with
squeeze-excite, SiLU, symmetric ``kernel // 2`` padding, compound width and
depth scaling, BatchNorm with momentum 0.9 (torch's 0.1) and eps 1e-5, and
no stochastic depth or dropout. Truncated after the 1x1 head conv (stride
32), or globally pooled for regression models.

Parameter names are the flax module's (``stem_conv``, ``stem_bn``,
``stage{s}_{i}.{expand_conv, expand_bn, dw_conv, dw_bn, se.reduce,
se.expand, project_conv, project_bn}``, ``head_conv``, ``head_bn``), so the
checkpoint bridge maps them leaf by leaf; torchvision's ``features.N.M.
block.*`` names map to them in ``models/backbones/pretrained.py``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lightning_pose_tpu_torch.models.backbones.resnet import BN_EPS, BatchNorm2d

__all__ = ["EFFICIENTNET_CONFIGS", "EfficientNet", "MBConv", "SqueezeExcite", "stage_layout"]

# variant -> (width_mult, depth_mult, num_output_features)
EFFICIENTNET_CONFIGS: dict[str, tuple[float, float, int]] = {
    "b0": (1.0, 1.0, 1280),
    "b1": (1.0, 1.1, 1280),
    "b2": (1.1, 1.2, 1408),
}

# (expand_ratio, channels, num_layers, stride, kernel) of b0
BASE_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]


def round_channels(c: float, divisor: int = 8) -> int:
    new_c = max(divisor, int(c + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * c:
        new_c += divisor
    return new_c


def round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def stage_layout(variant: str) -> list[tuple[int, int, int, int, int]]:
    """The blocks of a variant, in order: ``(stage, index, expand_ratio,
    stride, kernel)``, the stage counted from 1."""
    _, depth_mult, _ = EFFICIENTNET_CONFIGS[variant]
    return [
        (stage + 1, i, expand, stride if i == 0 else 1, kernel)
        for stage, (expand, _, layers, stride, kernel) in enumerate(BASE_STAGES)
        for i in range(round_repeats(layers, depth_mult))
    ]


def _bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=BN_EPS, momentum=0.1)


class SqueezeExcite(nn.Module):
    """Channel gate: spatial mean -> 1x1 ``reduce`` -> SiLU -> 1x1
    ``expand`` -> sigmoid, times the input."""

    def __init__(self, channels: int, se_channels: int) -> None:
        super().__init__()
        self.reduce = nn.Conv2d(channels, se_channels, 1)
        self.expand = nn.Conv2d(se_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.expand(F.silu(self.reduce(s)))
        return x * torch.sigmoid(s)


class MBConv(nn.Module):
    """[1x1 expand ->] depthwise kxk (strided) -> squeeze-excite -> 1x1
    project, with a residual when the shape is kept."""

    def __init__(
        self, in_channels: int, out_channels: int, expand_ratio: int, stride: int, kernel: int, se_channels: int
    ) -> None:
        super().__init__()
        mid = in_channels * expand_ratio
        self.expand_ratio = expand_ratio
        if expand_ratio != 1:
            self.expand_conv = nn.Conv2d(in_channels, mid, 1, bias=False)
            self.expand_bn = _bn(mid)
        self.dw_conv = nn.Conv2d(mid, mid, kernel, stride=stride, padding=kernel // 2, groups=mid, bias=False)
        self.dw_bn = _bn(mid)
        self.se = SqueezeExcite(mid, se_channels)
        self.project_conv = nn.Conv2d(mid, out_channels, 1, bias=False)
        self.project_bn = _bn(out_channels)
        self.residual = stride == 1 and in_channels == out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        if self.expand_ratio != 1:
            y = F.silu(self.expand_bn(self.expand_conv(y)))
        y = F.silu(self.dw_bn(self.dw_conv(y)))
        y = self.project_bn(self.project_conv(self.se(y)))
        return y + x if self.residual else y


class EfficientNet(nn.Module):
    """Truncated EfficientNet: ``(B, 3, H, W)`` -> ``(B, C, H/32, W/32)``, or
    ``(B, C)`` with ``global_pool``."""

    def __init__(self, variant: str = "b0", global_pool: bool = False) -> None:
        super().__init__()
        width_mult, _, head_channels = EFFICIENTNET_CONFIGS[variant]
        self.variant = variant
        self.global_pool = global_pool
        self.num_features = head_channels
        stem = round_channels(32 * width_mult)
        self.stem_conv = nn.Conv2d(3, stem, 3, stride=2, padding=1, bias=False)
        self.stem_bn = _bn(stem)
        in_c = stem
        self.block_names = []
        for stage, i, expand, stride, kernel in stage_layout(variant):
            out_c = round_channels(BASE_STAGES[stage - 1][1] * width_mult)
            name = f"stage{stage}_{i}"
            setattr(self, name, MBConv(in_c, out_c, expand, stride, kernel, se_channels=max(1, in_c // 4)))
            self.block_names.append(name)
            in_c = out_c
        self.head_conv = nn.Conv2d(in_c, head_channels, 1, bias=False)
        self.head_bn = _bn(head_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.stem_bn(self.stem_conv(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = F.silu(self.head_bn(self.head_conv(x)))
        if self.global_pool:
            x = x.mean(dim=(2, 3))
        return x
