"""Seeded synthetic labeled data and unlabeled video for smoke runs and
tests.

``write_labeled_dataset`` writes what a labeling project holds: PNG frames
under ``labeled-data/``, a DLC-format ``CollectedData.csv`` (scorer,
bodyparts, coords header rows), and an empty ``videos/`` directory. Each
frame is a dark background with one Gaussian blob per keypoint at its
label, so a model can learn the labels. ``write_unlabeled_video`` adds an
mp4 to ``videos/`` in which such blobs drift smoothly from frame to frame,
the unlabeled stream of semi-supervised training.

``write_multiview_dataset`` and ``write_multiview_videos`` write the same
for a multiview project, uncalibrated: one camera a view looking at the
same 3D blobs along another axis (view ``v`` sees ``(x, y)`` rotated about
the vertical axis by ``v * 90 / (V - 1)`` degrees), frames under
``labeled-data/<session>_<view>/``, one ``CollectedData_<view>.csv`` a view,
and frame-synchronized ``videos/<session>_<view>.mp4``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "write_labeled_dataset",
    "write_multiview_dataset",
    "write_multiview_videos",
    "write_unlabeled_video",
]


def write_labeled_dataset(
    root: str | Path,
    n_frames: int,
    height: int,
    width: int,
    keypoint_names: list[str],
    seed: int = 0,
    nan_fraction: float = 0.05,
) -> Path:
    """Write ``n_frames`` labeled ``(height, width)`` RGB frames under
    ``root``; a ``nan_fraction`` of the labels are NaN (unlabeled).
    Returns ``root``."""
    import cv2
    import pandas as pd

    root = Path(root)
    (root / "labeled-data").mkdir(parents=True, exist_ok=True)
    (root / "videos").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    k = len(keypoint_names)
    colors = rng.uniform(80, 255, (k, 3))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    labels = np.stack(
        [rng.uniform(0.1, 0.9, (n_frames, k)) * width, rng.uniform(0.1, 0.9, (n_frames, k)) * height],
        axis=-1,
    )
    names = []
    for i in range(n_frames):
        frame = rng.uniform(0, 30, (height, width, 3))
        for j in range(k):
            x, y = labels[i, j]
            blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0**2))
            frame = np.maximum(frame, blob[..., None] * colors[j])
        name = f"labeled-data/img{i:04d}.png"
        cv2.imwrite(str(root / name), np.clip(frame, 0, 255).astype(np.uint8)[..., ::-1])
        names.append(name)
    labels[rng.uniform(size=(n_frames, k)) < nan_fraction] = np.nan
    columns = pd.MultiIndex.from_tuples(
        [("synthetic", kp, c) for kp in keypoint_names for c in ("x", "y")],
        names=["scorer", "bodyparts", "coords"],
    )
    pd.DataFrame(labels.reshape(n_frames, 2 * k), index=names, columns=columns).to_csv(
        root / "CollectedData.csv"
    )
    return root


def write_unlabeled_video(
    root: str | Path,
    name: str,
    n_frames: int,
    height: int,
    width: int,
    n_blobs: int = 4,
    seed: int = 0,
) -> Path:
    """Write ``root/videos/<name>.mp4``: ``n_frames`` RGB frames of
    ``(height, width)`` in which ``n_blobs`` Gaussian blobs drift along
    smooth paths. Returns the file's path."""
    import cv2

    path = Path(root) / "videos" / f"{name}.mp4"
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    colors = rng.uniform(80, 255, (n_blobs, 3))
    start = rng.uniform(0.2, 0.8, (n_blobs, 2)) * (width, height)
    amplitude = rng.uniform(0.05, 0.15, (n_blobs, 2)) * (width, height)
    period = rng.uniform(40, 120, (n_blobs, 1))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (width, height))
    try:
        for t in range(n_frames):
            centers = start + amplitude * np.sin(2 * np.pi * t / period)
            frame = rng.uniform(0, 30, (height, width, 3))
            for (x, y), color in zip(centers, colors):
                blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0**2))
                frame = np.maximum(frame, blob[..., None] * color)
            writer.write(np.clip(frame, 0, 255).astype(np.uint8)[..., ::-1])
    finally:
        writer.release()
    return path


def _view_projection(points: np.ndarray, view: int, n_views: int, height: int, width: int) -> np.ndarray:
    """``(..., 3)`` points in [0, 1]^3 -> ``(..., 2)`` pixels of camera
    ``view``: an orthographic view rotated about the vertical axis."""
    angle = np.deg2rad(90.0 * view / max(n_views - 1, 1))
    x, y, z = points[..., 0] - 0.5, points[..., 1], points[..., 2] - 0.5
    u = 0.5 + (np.cos(angle) * x + np.sin(angle) * z) / np.sqrt(2.0)
    return np.stack([u * width, y * height], axis=-1)


def _blob_frame(rng, centers: np.ndarray, colors: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    frame = rng.uniform(0, 30, (*yy.shape, 3))
    for (x, y), color in zip(centers, colors):
        blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0**2))
        frame = np.maximum(frame, blob[..., None] * color)
    return np.clip(frame, 0, 255).astype(np.uint8)


def write_multiview_dataset(
    root: str | Path,
    n_frames: int,
    height: int,
    width: int,
    keypoint_names: list[str],
    view_names: list[str],
    session: str = "synth",
    seed: int = 0,
    nan_fraction: float = 0.05,
) -> Path:
    """Write ``n_frames`` labeled frames of each view under ``root``:
    ``labeled-data/<session>_<view>/img%04d.png`` and
    ``CollectedData_<view>.csv``, the labels of one 3D keypoint set seen by
    each camera; a ``nan_fraction`` of each view's labels are NaN. Returns
    ``root``."""
    import cv2
    import pandas as pd

    root = Path(root)
    (root / "videos").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    k = len(keypoint_names)
    colors = rng.uniform(80, 255, (k, 3))
    points = rng.uniform(0.15, 0.85, (n_frames, k, 3))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    columns = pd.MultiIndex.from_tuples(
        [("synthetic", kp, c) for kp in keypoint_names for c in ("x", "y")],
        names=["scorer", "bodyparts", "coords"],
    )
    for v, view in enumerate(view_names):
        folder = root / "labeled-data" / f"{session}_{view}"
        folder.mkdir(parents=True, exist_ok=True)
        labels = _view_projection(points, v, len(view_names), height, width)
        names = []
        for i in range(n_frames):
            name = f"labeled-data/{session}_{view}/img{i:04d}.png"
            cv2.imwrite(str(root / name), _blob_frame(rng, labels[i], colors, yy, xx)[..., ::-1])
            names.append(name)
        labels[rng.uniform(size=(n_frames, k)) < nan_fraction] = np.nan
        pd.DataFrame(labels.reshape(n_frames, 2 * k), index=names, columns=columns).to_csv(
            root / f"CollectedData_{view}.csv"
        )
    return root


def write_multiview_videos(
    root: str | Path,
    session: str,
    n_frames: int,
    height: int,
    width: int,
    view_names: list[str],
    n_blobs: int = 4,
    seed: int = 0,
) -> list[Path]:
    """Write ``root/videos/<session>_<view>.mp4`` for each view: ``n_frames``
    frames of ``n_blobs`` 3D blobs drifting along smooth paths, each view's
    camera seeing the same blobs at the same time. Returns the files in
    view order."""
    import cv2

    rng = np.random.default_rng(seed)
    colors = rng.uniform(80, 255, (n_blobs, 3))
    start = rng.uniform(0.3, 0.7, (n_blobs, 3))
    amplitude = rng.uniform(0.05, 0.15, (n_blobs, 3))
    period = rng.uniform(40, 120, (n_blobs, 1))
    t = np.arange(n_frames)[:, None, None]
    points = start + amplitude * np.sin(2 * np.pi * t / period)  # (T, n_blobs, 3)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    paths = []
    for v, view in enumerate(view_names):
        path = Path(root) / "videos" / f"{session}_{view}.mp4"
        path.parent.mkdir(parents=True, exist_ok=True)
        centers = _view_projection(points, v, len(view_names), height, width)
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (width, height))
        try:
            for i in range(n_frames):
                writer.write(_blob_frame(rng, centers[i], colors, yy, xx)[..., ::-1])
        finally:
            writer.release()
        paths.append(path)
    return paths
