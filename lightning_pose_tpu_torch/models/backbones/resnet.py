"""ResNet backbones (counterpart of
``lightning_pose_tpu/models/backbones/resnet.py``).

torchvision's architecture and parameter names (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer1.0.downsample.0``, ...), truncated after the last
residual stage (stride 32) for heatmap models, or globally pooled. Inputs
are ``(B, 3, H, W)``; the port runs them channels-last.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

__all__ = ["ResNet", "BasicBlock", "BottleneckBlock", "RESNET_CONFIGS", "max_pool_3x3_s2"]

# name: (blocks per stage, bottleneck, output features)
RESNET_CONFIGS: dict[str, tuple[Sequence[int], bool, int]] = {
    "resnet18": ((2, 2, 2, 2), False, 512),
    "resnet34": ((3, 4, 6, 3), False, 512),
    "resnet50": ((3, 4, 6, 3), True, 2048),
    "resnet101": ((3, 4, 23, 3), True, 2048),
    "resnet152": ((3, 8, 36, 3), True, 2048),
}

BN_EPS = 1e-5


def _bn(features: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(features, eps=BN_EPS, momentum=0.1)


def _downsample(in_features: int, out_features: int, stride: int) -> nn.Sequential | None:
    if stride == 1 and in_features == out_features:
        return None
    return nn.Sequential(
        nn.Conv2d(in_features, out_features, 1, stride=stride, bias=False),
        _bn(out_features),
    )


class BasicBlock(nn.Module):
    """Two 3x3 convs with an identity or 1x1 shortcut (resnet18/34)."""

    expansion = 1

    def __init__(self, in_features: int, features: int, stride: int) -> None:
        super().__init__()
        self.conv1 = nn.Conv2d(in_features, features, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.downsample = _downsample(in_features, features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + residual)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 bottleneck with 4x expansion (resnet50+)."""

    expansion = 4

    def __init__(self, in_features: int, features: int, stride: int) -> None:
        super().__init__()
        out_features = features * self.expansion
        self.conv1 = nn.Conv2d(in_features, features, 1, bias=False)
        self.bn1 = _bn(features)
        self.conv2 = nn.Conv2d(features, features, 3, stride=stride, padding=1, bias=False)
        self.bn2 = _bn(features)
        self.conv3 = nn.Conv2d(features, out_features, 1, bias=False)
        self.bn3 = _bn(out_features)
        self.downsample = _downsample(in_features, out_features, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return torch.relu(y + residual)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool, stride 2, padding 1 with -inf (the reference's
    ``reduce_window`` with a -inf init)."""
    return nn.functional.max_pool2d(x, kernel_size=3, stride=2, padding=1)


class ResNet(nn.Module):
    """Truncated ResNet: ``(B, 3, H, W)`` -> ``(B, C, H/32, W/32)``, or
    ``(B, C)`` with ``global_pool``."""

    def __init__(self, arch: str = "resnet50", global_pool: bool = False) -> None:
        super().__init__()
        stage_sizes, bottleneck, num_features = RESNET_CONFIGS[arch]
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        self.arch = arch
        self.global_pool = global_pool
        self.num_features = num_features
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _bn(64)
        in_features = 64
        for stage, num_blocks in enumerate(stage_sizes):
            width = 64 * 2**stage
            blocks = []
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                blocks.append(block_cls(in_features, width, stride))
                in_features = width * block_cls.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = max_pool_3x3_s2(torch.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        if self.global_pool:
            x = x.mean(dim=(2, 3))
        return x
