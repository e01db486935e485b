"""Augmentation of unlabeled video windows on the device, the DALI train
pipe's equivalent (counterpart of ``lightning_pose_tpu/ops/video_augment.py``;
reference lightning_pose/data/dali.py:156-182).

Per window: one rotation ~U(-10, 10) degrees and one anisotropic scale
~U(0.8, 1.2)^2 about the image centre for all its frames (a single warp;
the forward 2x3 matrix is returned for the undo step), brightness and
contrast ~U(0.75, 1.25), shot noise of factor ~U(0, 10). The ImageNet
normalization follows in the train step.

Split as the labeled engine is (``ops/augment.py``): :func:`sample_video_draws`
makes the random draws (the five scalars on the host, the normal noise
field on its generator's device) and :func:`augment_video_sequence` is
deterministic given them, so the tests replay the JAX package's draws. The
warp is the warp kernel (``ops/warp_kernel.py``), which takes one coordinate
field per image: the window's one ``(H, W, 2)`` field is expanded to ``T``
contiguous copies (16.8 MB at T = 32 and 256 px).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from lightning_pose_tpu_torch.ops.warp_kernel import warp

__all__ = ["VideoDraws", "augment_video_sequence", "sample_video_draws"]

_ROT_DEG = 10.0
_SCALE_LO, _SCALE_HI = 0.8, 1.2
_PHOTO_LO, _PHOTO_HI = 0.75, 1.25
_SHOT_HI = 10.0


@dataclass
class VideoDraws:
    """The random draws of one window, named after the JAX keys they
    replace (``split(rng, 6)`` of ``augment_video_sequence``). The scalars
    are CPU tensors; ``noise`` lies on the frames' device."""

    angle_deg: torch.Tensor   # k_rot, ()
    scale: torch.Tensor       # k_scale, (2,)
    brightness: torch.Tensor  # k_bright, ()
    contrast: torch.Tensor    # k_contrast, ()
    shot_factor: torch.Tensor  # k_shot, ()
    noise: torch.Tensor       # k_noise, (T, H, W, 3) standard normal


def sample_video_draws(
    generator: torch.Generator,
    t: int,
    h: int,
    w: int,
    field_generator: torch.Generator | None = None,
) -> VideoDraws:
    """The draws of one ``(t, h, w, 3)`` window: the scalars from the CPU
    ``generator``, the noise field from ``field_generator`` (default
    ``generator``) on its own device."""
    if generator.device.type != "cpu":
        raise ValueError("the per-window draws come from a CPU generator")
    field_generator = field_generator or generator

    def between(lo, hi, *shape):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    return VideoDraws(
        angle_deg=between(-_ROT_DEG, _ROT_DEG),
        scale=between(_SCALE_LO, _SCALE_HI, 2),
        brightness=between(_PHOTO_LO, _PHOTO_HI),
        contrast=between(_PHOTO_LO, _PHOTO_HI),
        shot_factor=between(0.0, _SHOT_HI),
        noise=torch.randn((t, h, w, 3), generator=field_generator, device=field_generator.device),
    )


def _forward_matrix(draws: VideoDraws, h: int, w: int) -> torch.Tensor:
    """The window's forward ``(2, 3)`` float32 matrix on the host: scale,
    then rotate, about the image centre."""
    angle = draws.angle_deg.to(torch.float32) * (math.pi / 180.0)
    sx, sy = draws.scale.to(torch.float32).unbind()
    cx, cy = w / 2.0, h / 2.0
    cos, sin = torch.cos(angle), torch.sin(angle)
    a00, a01, a10, a11 = cos * sx, -sin * sy, sin * sx, cos * sy
    tx = cx - a00 * cx - a01 * cy
    ty = cy - a10 * cx - a11 * cy
    return torch.stack([torch.stack([a00, a01, tx]), torch.stack([a10, a11, ty])])


def augment_video_sequence(
    frames: torch.Tensor, draws: VideoDraws, apply_geometric: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """Augment one window ``(T, H, W, 3)`` of 0-255 values with ``draws``.

    Returns the augmented frames, float32 0-255, and the forward ``(T, 2,
    3)`` matrices (the identity without ``apply_geometric``), on the frames'
    device.
    """
    t, h, w, _ = frames.shape
    dev = frames.device
    frames = frames.to(torch.float32)
    if apply_geometric:
        forward = _forward_matrix(draws, h, w)
        inverse = torch.linalg.inv(torch.cat([forward, torch.tensor([[0.0, 0.0, 1.0]])]))
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=dev),
            torch.arange(w, dtype=torch.float32, device=dev),
            indexing="ij",
        )
        grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
        coords = torch.einsum("ij,hwj->hwi", inverse.to(dev, non_blocking=True), grid)[..., :2]
        frames = warp(frames.contiguous(), coords.expand(t, h, w, 2).contiguous())
        transforms = forward.to(dev, non_blocking=True).expand(t, 2, 3)
    else:
        transforms = torch.eye(2, 3, dtype=torch.float32, device=dev).expand(t, 2, 3)

    # brightness / contrast (DALI brightness_contrast semantics:
    # out = brightness * (offset + contrast * (in - offset)), offset = 128)
    brightness, contrast, factor = (float(v) for v in (draws.brightness, draws.contrast, draws.shot_factor))
    frames = brightness * (128.0 + contrast * (frames - 128.0))
    # shot noise: a Gaussian approximation with variance factor * intensity
    frames = frames + draws.noise.to(dev) * torch.sqrt(frames.clamp(min=0.0) * factor / 12.75)
    return frames.clamp(0.0, 255.0), transforms
