"""Differentiable camera geometry (counterpart of
``lightning_pose_tpu/data/cameras.py``).

- pairwise 2D -> 3D triangulation over every camera pair (DLT: the null
  vector of ``AᵀA`` by ``torch.linalg.eigh``, its eigenvector of the
  smallest eigenvalue), NaN in, NaN out;
- 3D -> 2D projection with Brown-Conrady distortion (``k1, k2, p1, p2,
  k3``, cv2's convention) and its fixed-point inverse;
- ``triangulate_fast``, the host utility: the median over camera pairs.

The functions are batched tensor functions: they broadcast over the batch,
the camera pairs and the keypoints, and are differentiable with respect to
the points. Pairs come in ``itertools.combinations`` order.

:func:`nanmedian` is ``jnp.nanmedian``: on an even count of finite values it
averages the two middle ones, where ``torch.nanmedian`` returns the lower.

fp32 triangulation is ill-conditioned when the cameras are far from a small
scene: two fp32 implementations (LAPACK against cuSOLVER) may differ by
whole units in 3D while their reprojections agree within a fraction of a
pixel. Compare them in float64, or in reprojected pixels.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = [
    "CameraGroup",
    "camera_pairs",
    "distort_points",
    "nanmedian",
    "project_3d_to_2d",
    "project_camera_pairs_to_3d",
    "triangulate_fast",
    "triangulate_pair",
    "undistort_points",
]

# the system of a pair with a NaN point is swapped for this one (distinct
# eigenvalues, so that eigh and its backward stay finite); its result is
# replaced by NaN
_SAFE_SYSTEM = torch.diag(torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64))


def camera_pairs(num_views: int) -> list[tuple[int, int]]:
    """The camera pairs ``(i, j)``, ``i < j``, in ``itertools.combinations`` order."""
    return list(itertools.combinations(range(num_views), 2))


def nanmedian(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The median over ``dim`` of the values that are not NaN, the two
    middle values averaged on an even count (``jnp.nanmedian``); NaN where
    every value is NaN."""
    x = torch.movedim(x, dim, -1)
    ordered, _ = torch.sort(x, dim=-1)  # NaN sorts last
    n = (~torch.isnan(x)).sum(dim=-1, keepdim=True)
    low = torch.div(n - 1, 2, rounding_mode="floor").clamp(min=0)
    high = torch.minimum(torch.div(n, 2, rounding_mode="floor"), n - 1).clamp(min=0)
    values = (torch.gather(ordered, -1, low) + torch.gather(ordered, -1, high)) * 0.5
    return values.squeeze(-1)


def _projection_matrices(intrinsics: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """``P = K [R|t]`` of each camera: ``(..., 3, 3) @ (..., 3, 4)``."""
    return intrinsics @ extrinsics


def triangulate_pair(p1: torch.Tensor, p2: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation of one camera pair.

    Args:
        p1, p2: ``(..., 3, 4)`` projection matrices, their leading dims
            broadcasting against the points' (for example ``(B, 1, 3, 4)``
            against ``(B, K, 2)``).
        pts1, pts2: ``(..., 2)`` undistorted pixels in each view.

    Returns:
        ``(..., 3)`` world points; NaN where a point is NaN.
    """
    invalid = torch.isnan(pts1).any(dim=-1) | torch.isnan(pts2).any(dim=-1)

    def rows(p, pts):
        pts = torch.where(torch.isnan(pts), 0.0, pts)
        x, y = pts[..., 0:1], pts[..., 1:2]
        return torch.stack([x * p[..., 2, :] - p[..., 0, :], y * p[..., 2, :] - p[..., 1, :]], dim=-2)

    a = torch.cat([rows(p1, pts1), rows(p2, pts2)], dim=-2)  # (..., 4, 4)
    ata = a.transpose(-1, -2) @ a
    safe = _SAFE_SYSTEM.to(device=ata.device, dtype=ata.dtype)
    ata = torch.where(invalid[..., None, None], safe, ata)
    _, vecs = torch.linalg.eigh(ata)
    x = vecs[..., :, 0]  # the eigenvector of the smallest eigenvalue
    out = x[..., :3] / (x[..., 3:4] + 1e-12)
    return torch.where(invalid[..., None], float("nan"), out)


def _camera_terms(intrinsics: torch.Tensor, dist: torch.Tensor):
    """fx, fy, cx, cy and k1, k2, p1, p2, k3, each with a trailing axis to
    broadcast over the keypoints."""
    fx, fy = intrinsics[..., 0, 0, None], intrinsics[..., 1, 1, None]
    cx, cy = intrinsics[..., 0, 2, None], intrinsics[..., 1, 2, None]
    return (fx, fy, cx, cy), tuple(dist[..., i, None] for i in range(5))


def distort_points(points: torch.Tensor, intrinsics: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    """Brown-Conrady distortion of pixels.

    Args:
        points: ``(..., K, 2)`` pixels.
        intrinsics: ``(..., 3, 3)``, the points' leading dims.
        dist: ``(..., 5)`` ``[k1, k2, p1, p2, k3]``.
    """
    (fx, fy, cx, cy), (k1, k2, p1, p2, k3) = _camera_terms(intrinsics, dist)
    x = (points[..., 0] - cx) / fx
    y = (points[..., 1] - cy) / fy
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([x_d * fx + cx, y_d * fy + cy], dim=-1)


def undistort_points(
    points: torch.Tensor, intrinsics: torch.Tensor, dist: torch.Tensor, iters: int = 5
) -> torch.Tensor:
    """The inverse of :func:`distort_points` by ``iters`` fixed-point
    iterations (cv2's ``undistortPoints`` approach); same shapes."""
    (fx, fy, cx, cy), (k1, k2, p1, p2, k3) = _camera_terms(intrinsics, dist)
    xd = (points[..., 0] - cx) / fx
    yd = (points[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


def _common(points: torch.Tensor, *cameras: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The points and camera arrays in one floating dtype (the wider)."""
    dtype = points.dtype
    for c in cameras:
        dtype = torch.promote_types(dtype, c.dtype)
    return tuple(t.to(dtype) for t in (points, *cameras))


def project_camera_pairs_to_3d(
    points: torch.Tensor, intrinsics: torch.Tensor, extrinsics: torch.Tensor, dist: torch.Tensor
) -> torch.Tensor:
    """Triangulate every camera pair.

    Args:
        points: ``(B, V, K, 2)`` distorted pixels.
        intrinsics: ``(B, V, 3, 3)``.
        extrinsics: ``(B, V, 3, 4)``.
        dist: ``(B, V, 5)``.

    Returns:
        ``(B, P, K, 3)`` world points, ``P = V (V - 1) / 2`` pairs in
        ``itertools.combinations`` order; NaN where either view's point is.
    """
    # K [R|t] in the cameras' own dtype, as the JAX package multiplies it
    proj = _projection_matrices(intrinsics, extrinsics)
    points, intrinsics, proj, dist = _common(points, intrinsics, proj, dist)
    pairs = camera_pairs(points.shape[1])
    first = torch.tensor([i for i, _ in pairs], device=points.device)
    second = torch.tensor([j for _, j in pairs], device=points.device)
    undistorted = undistort_points(points, intrinsics, dist)  # (B, V, K, 2)
    proj = proj[:, :, None]  # (B, V, 1, 3, 4)
    return triangulate_pair(proj[:, first], proj[:, second], undistorted[:, first], undistorted[:, second])


def project_3d_to_2d(
    points_3d: torch.Tensor, intrinsics: torch.Tensor, extrinsics: torch.Tensor, dist: torch.Tensor
) -> torch.Tensor:
    """Project world points into every camera, with distortion.

    Args:
        points_3d: ``(B, K, 3)``.
        intrinsics: ``(B, V, 3, 3)``.
        extrinsics: ``(B, V, 3, 4)``.
        dist: ``(B, V, 5)``.

    Returns:
        ``(B, V, K, 2)`` pixels.
    """
    points_3d, intrinsics, extrinsics, dist = _common(points_3d, intrinsics, extrinsics, dist)
    homog = torch.cat([points_3d, torch.ones_like(points_3d[..., :1])], dim=-1)[:, None]  # (B, 1, K, 4)
    cam = homog @ extrinsics.transpose(-1, -2)  # (B, V, K, 3)
    xy = cam[..., :2] / (cam[..., 2:3] + 1e-12)
    (fx, fy, cx, cy), _ = _camera_terms(intrinsics, dist)
    pix = torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], dim=-1)
    return distort_points(pix, intrinsics, dist)


class CameraGroup:
    """Per-view camera parameters: ``(V, 3, 3)`` intrinsics, ``(V, 3, 4)``
    extrinsics, ``(V, 5)`` distortions (float32), with the host
    triangulation and the differentiable helpers bound to them."""

    def __init__(self, intrinsics: np.ndarray, extrinsics: np.ndarray, distortions: np.ndarray) -> None:
        self.intrinsics = np.asarray(intrinsics, dtype=np.float32)
        self.extrinsics = np.asarray(extrinsics, dtype=np.float32)
        self.distortions = np.asarray(distortions, dtype=np.float32)
        if (self.intrinsics.shape[1:], self.extrinsics.shape[1:], self.distortions.shape[1:]) != ((3, 3), (3, 4), (5,)):
            raise ValueError(
                f"cameras must be (V, 3, 3), (V, 3, 4) and (V, 5), got {self.intrinsics.shape}, "
                f"{self.extrinsics.shape} and {self.distortions.shape}"
            )

    @property
    def num_views(self) -> int:
        return self.intrinsics.shape[0]

    @classmethod
    def from_dict(cls, params: dict) -> "CameraGroup":
        return cls(params["intrinsics"], params["extrinsics"], params["distortions"])

    def triangulate_fast(self, points: np.ndarray) -> np.ndarray:
        """``(frames, views, keypoints, 2)`` -> ``(frames, keypoints, 3)``,
        the median over camera pairs."""
        return triangulate_fast(points, self.intrinsics, self.extrinsics, self.distortions)

    def _batched(self, b: int, like: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return tuple(
            torch.as_tensor(a, device=like.device).expand(b, *a.shape)
            for a in (self.intrinsics, self.extrinsics, self.distortions)
        )

    def triangulate_pairs(self, points: torch.Tensor) -> torch.Tensor:
        """Differentiable pairwise triangulation bound to these cameras."""
        return project_camera_pairs_to_3d(points, *self._batched(points.shape[0], points))

    def project(self, points_3d: torch.Tensor) -> torch.Tensor:
        """Differentiable 3D -> 2D projection bound to these cameras."""
        return project_3d_to_2d(points_3d, *self._batched(points_3d.shape[0], points_3d))


def triangulate_fast(
    points: np.ndarray, intrinsics: np.ndarray, extrinsics: np.ndarray, dist: np.ndarray
) -> np.ndarray:
    """Host triangulation: the median over every camera pair, on the CPU.

    Args:
        points: ``(frames, views, keypoints, 2)``.
        intrinsics, extrinsics, dist: ``(views, 3, 3)``, ``(views, 3, 4)``,
            ``(views, 5)``.

    Returns:
        ``(frames, keypoints, 3)`` numpy array, in the wider dtype of the
        points and the cameras.
    """
    pts = torch.from_numpy(np.ascontiguousarray(points))
    f, v = pts.shape[:2]
    cams = [torch.from_numpy(np.ascontiguousarray(a)).expand(f, v, *np.shape(a)[1:])
            for a in (intrinsics, extrinsics, dist)]
    with torch.no_grad():
        pairs = project_camera_pairs_to_3d(pts, *cams)
    return nanmedian(pairs, dim=1).numpy()
