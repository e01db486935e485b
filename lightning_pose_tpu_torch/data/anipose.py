"""Anipose camera-calibration TOML loading (counterpart of
``lightning_pose_tpu/data/anipose.py``; the port keeps its own copy).

Parses the anipose TOML format with the stdlib and returns plain numpy
camera arrays in the layout the calibrated train step consumes: intrinsics
``(V, 3, 3)``, extrinsics ``(V, 3, 4)`` world -> camera, distortions
``(V, 5)`` Brown-Conrady.

Anipose TOML layout: ``[cam_0] .. [cam_N]`` sections, each with ``name``,
``matrix`` (3x3), ``rotation`` (Rodrigues 3-vector), ``translation`` (3),
``distortions`` (k1 [, k2, p1, p2, k3]); plus a ``[metadata]`` section.
"""

from __future__ import annotations

import tomllib

import numpy as np

__all__ = ["rodrigues", "load_anipose_toml"]


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rodrigues rotation vector -> 3x3 rotation matrix (cv2.Rodrigues
    semantics, pure numpy)."""
    rvec = np.asarray(rvec, dtype=np.float64).reshape(3)
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kx = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]], dtype=np.float64
    )
    return np.eye(3) * np.cos(theta) + (1 - np.cos(theta)) * np.outer(k, k) + (
        np.sin(theta) * kx
    )


def load_anipose_toml(path: str) -> dict:
    """Parse an anipose calibration TOML.

    Returns dict with ``names`` (list, cam-section order), ``intrinsics``
    (V, 3, 3), ``extrinsics`` (V, 3, 4), ``distortions`` (V, 5) float32.
    """
    with open(path, "rb") as f:
        data = tomllib.load(f)

    cam_keys = sorted(
        (k for k in data if k.startswith("cam_")),
        key=lambda k: int(k.split("_", 1)[1]),
    )
    if not cam_keys:
        raise ValueError(f"no [cam_N] sections found in {path}")

    names, intr, extr, dist = [], [], [], []
    for key in cam_keys:
        cam = data[key]
        names.append(str(cam.get("name", key)))
        k_mat = np.asarray(cam["matrix"], dtype=np.float64).reshape(3, 3)
        r_mat = rodrigues(np.asarray(cam["rotation"], dtype=np.float64))
        t = np.asarray(cam["translation"], dtype=np.float64).reshape(3, 1)
        d = np.asarray(cam.get("distortions", []), dtype=np.float64).reshape(-1)
        d = np.pad(d[:5], (0, max(0, 5 - min(len(d), 5))))
        intr.append(k_mat)
        extr.append(np.concatenate([r_mat, t], axis=1))
        dist.append(d)

    return {
        "names": names,
        "intrinsics": np.stack(intr).astype(np.float32),
        "extrinsics": np.stack(extr).astype(np.float32),
        "distortions": np.stack(dist).astype(np.float32),
    }
