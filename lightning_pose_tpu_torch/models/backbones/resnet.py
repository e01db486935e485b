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

__all__ = [
    "BasicBlock",
    "BatchNorm2d",
    "BottleneckBlock",
    "RESNET_CONFIGS",
    "ResNet",
    "max_pool_3x3_s2",
]

# name: (blocks per stage, bottleneck, output features)
RESNET_CONFIGS: dict[str, tuple[Sequence[int], bool, int]] = {
    "resnet18": ((2, 2, 2, 2), False, 512),
    "resnet34": ((3, 4, 6, 3), False, 512),
    "resnet50": ((3, 4, 6, 3), True, 2048),
    "resnet101": ((3, 4, 23, 3), True, 2048),
    "resnet152": ((3, 8, 36, 3), True, 2048),
}

BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose train-mode update of ``running_var`` uses the
    biased batch variance, as flax's ``BatchNorm`` does; torch's uses the
    unbiased one.

    The forward pass is torch's own (cuDNN's fused kernel on the card). The
    update is then corrected per channel, with no extra pass over the
    activations: torch set ``rv = k*old + m*var*n/(n-1)`` with ``k = 1 - m``,
    and ``lerp(k*old, rv, (n-1)/n)`` is ``k*old + m*var``, where ``n`` is
    the number of values per channel. Two small ops per layer: the multiply
    and the lerp.

    In training under a process group of more than one rank, the statistics
    are the global batch's, as GSPMD gives them to the JAX package: each
    rank's per-channel count, mean and sum of squared deviations are merged
    over the ranks (Chan's parallel form of Welford's update: one all-reduce
    for the mean, one for the squared deviations about it), through the
    autograd-aware ``torch.distributed.nn.functional.all_reduce``, so that
    the backward reaches every rank's rows. ``nn.SyncBatchNorm`` is not used:
    it refuses CPU tensors and keeps torch's unbiased running variance.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if torch.distributed.is_available() and torch.distributed.is_initialized() \
                and torch.distributed.get_world_size() > 1:
            return self._cross_replica(x)
        keep = self.running_var * (1.0 - self.momentum)
        y = super().forward(x)
        n = x.numel() // x.shape[1]
        # a new buffer, not an in-place update: autograd saved the old one
        with torch.no_grad():
            self.running_var = torch.lerp(keep, self.running_var, (n - 1) / n)
        return y

    def _cross_replica(self, x: torch.Tensor) -> torch.Tensor:
        """The train-mode forward over every rank's batch: normalized by the
        global mean and biased variance, which also update the running
        statistics."""
        from torch.distributed.nn.functional import all_reduce

        # the statistics in fp32 at least (float64 stays float64)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3)
        count = torch.full((1,), x.numel() // x.shape[1], dtype=torch.float32, device=x.device)
        local_mean = xf.mean(dims)
        total = all_reduce(torch.cat([count, count * local_mean]))
        n, mean = total[0], total[1:] / total[0]
        local_m2 = (xf - local_mean[None, :, None, None]).square().sum(dims)
        m2 = all_reduce(local_m2 + count * (local_mean - mean).square())
        var = m2 / n
        y = (xf - mean[None, :, None, None]) * torch.rsqrt(var + self.eps)[None, :, None, None]
        if self.affine:
            y = y * self.weight[None, :, None, None] + self.bias[None, :, None, None]
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var = torch.lerp(self.running_var, var.detach(), self.momentum)
        return y.to(x.dtype)


def _bn(features: int) -> BatchNorm2d:
    return BatchNorm2d(features, eps=BN_EPS, momentum=0.1)


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
