"""3D scale/translate augmentation of calibrated multiview batches
(counterpart of ``lightning_pose_tpu/ops/augment3d.py``).

Triangulate the labeled keypoints to 3D (the median over camera pairs),
scale the 3D points about their centroid and translate them by a share of
the scene's extent, reproject them into every camera, fit a similarity
transform per view image from the old keypoints to the new ones (in model
pixels), and resample every view image through its inverse: all ``B*V``
images in one launch of the warp kernel (``ops/warp_kernel.warp``; its
plain version on the CPU).

Split as ``ops/augment.py`` is: :func:`sample` draws the apply flags, the
scales and the translations from an explicit ``torch.Generator``;
:func:`apply` is a pure function of those draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from lightning_pose_tpu_torch.data.cameras import nanmedian, project_3d_to_2d, project_camera_pairs_to_3d
from lightning_pose_tpu_torch.ops.warp_kernel import warp

__all__ = ["Draws3D", "apply", "fit_similarity_transform", "sample", "sampling_coords"]


@dataclass
class Draws3D:
    """The draws of one call on ``B`` samples, CPU tensors: ``apply_u``
    ``(B,)`` uniforms in [0, 1) (the sample is augmented where ``apply_u <
    apply_prob``), ``scale`` ``(B,)`` in the scale range, ``translate``
    ``(B, 3)`` in [-1, 1) (times the translate range and the extent)."""

    apply_u: torch.Tensor
    scale: torch.Tensor
    translate: torch.Tensor


def sample(generator: torch.Generator, b: int, scale_range: tuple[float, float] = (0.8, 1.2)) -> Draws3D:
    """The draws for ``b`` samples from a CPU generator."""
    lo, hi = scale_range
    apply_u = torch.rand(b, generator=generator)
    scale = torch.rand(b, generator=generator) * (hi - lo) + lo
    translate = torch.rand((b, 3), generator=generator) * 2.0 - 1.0
    return Draws3D(apply_u=apply_u, scale=scale, translate=translate)


def fit_similarity_transform(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Least-squares similarity transform (scale, rotation, translation)
    mapping ``src`` to ``dst``, ``(..., K, 2)`` each, pairs with a NaN left
    out; returns the forward ``(..., 3, 3)`` matrices. Fewer than 2 valid
    pairs, or valid points that all coincide, give the identity."""
    valid = ~(torch.isnan(src).any(dim=-1) | torch.isnan(dst).any(dim=-1))
    n_valid = valid.sum(dim=-1)
    wsum = n_valid.clamp(min=1).to(src.dtype)[..., None]
    w = valid.to(src.dtype)[..., None]
    src0, dst0 = torch.nan_to_num(src, nan=0.0), torch.nan_to_num(dst, nan=0.0)
    mu_s = (src0 * w).sum(dim=-2) / wsum
    mu_d = (dst0 * w).sum(dim=-2) / wsum
    sc = (src0 - mu_s[..., None, :]) * w
    dc = (dst0 - mu_d[..., None, :]) * w
    spread = (sc**2).sum(dim=(-1, -2))
    denom = spread + 1e-8
    a = (sc * dc).sum(dim=(-1, -2)) / denom
    b = (sc[..., 0] * dc[..., 1] - sc[..., 1] * dc[..., 0]).sum(dim=-1) / denom
    tx = mu_d[..., 0] - (a * mu_s[..., 0] - b * mu_s[..., 1])
    ty = mu_d[..., 1] - (b * mu_s[..., 0] + a * mu_s[..., 1])
    zeros, ones = torch.zeros_like(a), torch.ones_like(a)
    m = torch.stack(
        [torch.stack([a, -b, tx], dim=-1), torch.stack([b, a, ty], dim=-1), torch.stack([zeros, zeros, ones], dim=-1)],
        dim=-2,
    )
    degenerate = (n_valid < 2) | (spread < 1e-6)
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return torch.where(degenerate[..., None, None], eye, m)


def _affine(m: torch.Tensor, keypoints: torch.Tensor) -> torch.Tensor:
    """``(B, V, 3, 3)`` affines applied to ``(B, V, K, 2)`` points."""
    homog = torch.cat([keypoints, torch.ones_like(keypoints[..., :1])], dim=-1)
    return torch.einsum("bvij,bvkj->bvki", m, homog)[..., :2]


def sampling_coords(
    keypoints_frame: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    distortions: torch.Tensor,
    draws: Draws3D,
    image_hw: tuple[int, int],
    frame_to_model: torch.Tensor | None = None,
    translate_range: float = 0.1,
    apply_prob: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The geometry of :func:`apply` (its arguments but the images; the
    images' ``(H, W)``): the ``(B*V, H, W, 2)`` float32 coordinates each
    output pixel samples in its input view image, the keypoints in model
    pixels ``(B, V*K, 2)`` (moved where the sample is augmented) and the
    ``(B,)`` flags of the augmented samples."""
    h, w = image_hw
    b, v = intrinsics.shape[:2]
    k = keypoints_frame.shape[1] // v
    dev = keypoints_frame.device
    kp_views = keypoints_frame.reshape(b, v, k, 2)
    if frame_to_model is None:
        frame_to_model = torch.eye(3, dtype=kp_views.dtype, device=dev).expand(b, v, 3, 3)
    apply_flag = draws.apply_u.to(dev) < apply_prob
    scale = draws.scale.to(dev, kp_views.dtype)[:, None, None]

    pts3d = nanmedian(project_camera_pairs_to_3d(kp_views, intrinsics, extrinsics, distortions), dim=1)
    # fewer than 3 valid triangulated keypoints: the sample is not augmented
    valid_3d = (~torch.isnan(pts3d).any(dim=-1)).sum(dim=1)
    apply_flag = apply_flag & (valid_3d >= 3)

    centroid = torch.nanmean(pts3d, dim=1, keepdim=True)
    extent = torch.nan_to_num((pts3d - centroid).abs(), nan=0.0).amax(dim=(1, 2), keepdim=True)
    translate = draws.translate.to(dev, pts3d.dtype)[:, None, :] * translate_range * extent
    pts3d_new = (pts3d - centroid) * scale + centroid + translate

    missing = torch.isnan(kp_views)
    kp_new_frame = project_3d_to_2d(pts3d_new, intrinsics, extrinsics, distortions).to(kp_views.dtype)
    kp_new_frame = torch.where(missing, float("nan"), kp_new_frame)
    # the warp is fitted in model pixels, where the images are
    kp_old = _affine(frame_to_model, kp_views)
    kp_new = torch.where(missing, float("nan"), _affine(frame_to_model, kp_new_frame))

    inverses = torch.linalg.inv_ex(fit_similarity_transform(kp_old, kp_new)).inverse.to(torch.float32)
    ys, xs = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=dev), torch.arange(w, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)
    coords = torch.einsum("bvij,hwj->bvhwi", inverses, grid)[..., :2].reshape(b * v, h, w, 2).contiguous()
    keypoints = torch.where(apply_flag[:, None, None, None], kp_new, kp_old)
    return coords, keypoints.reshape(b, v * k, 2), apply_flag


def apply(
    images: torch.Tensor,
    keypoints_frame: torch.Tensor,
    intrinsics: torch.Tensor,
    extrinsics: torch.Tensor,
    distortions: torch.Tensor,
    draws: Draws3D,
    frame_to_model: torch.Tensor | None = None,
    translate_range: float = 0.1,
    apply_prob: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Augment a calibrated batch with ``draws`` (:func:`sample`).

    Args:
        images: ``(B, V, H, W, 3)`` float32 0-255 model-resolution views.
        keypoints_frame: ``(B, V*K, 2)`` view-major keypoints in the
            original frame's pixels (where the cameras are calibrated), NaN
            where missing.
        intrinsics, extrinsics, distortions: ``(B, V, 3, 3)``, ``(B, V, 3,
            4)``, ``(B, V, 5)``.
        frame_to_model: optional ``(B, V, 3, 3)`` affines from frame to
            model pixels; the identity when None.

    Returns:
        The images (warped where the sample is augmented) and the keypoints
        in model pixels, ``(B, V*K, 2)``; a sample with fewer than 3 valid
        triangulated keypoints is left as it is, and NaN labels stay NaN.
    """
    b, v, h, w, c = images.shape
    coords, keypoints, apply_flag = sampling_coords(
        keypoints_frame, intrinsics, extrinsics, distortions, draws, (h, w), frame_to_model, translate_range,
        apply_prob,
    )
    warped = warp(images.reshape(b * v, h, w, c), coords).reshape(images.shape)
    return torch.where(apply_flag[:, None, None, None, None], warped, images), keypoints
