"""Seeded synthetic video sessions (the benchmark's own generator).

A session is one mp4 a camera view: bright Gaussian blobs move fast in 3D
along smooth paths and each view sees them through its own orthographic
camera, so that the views are frame-synchronized. The background is the
ImageNet mean colour, which the model's normalization takes to zero, so
that the seeded weights of ``lpbench/weights.py`` answer the blobs alone and
every frame's answers differ from its neighbours' by much more than
rounding moves them. Every seed gives the same sizes, frame counts, speeds
and codec; only the paths and colours differ.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

__all__ = ["write_session"]

BLOBS = 5
# a blob's standard deviation, as a share of the frame's width
SIGMA = 0.04
FPS = 30.0
# the background: ImageNet's mean colour (RGB)
BACKGROUND = (124, 116, 104)


def _project(points: np.ndarray, view: int, n_views: int, height: int, width: int) -> np.ndarray:
    """``(..., 3)`` points in [0, 1]^3 -> ``(..., 2)`` pixels of camera
    ``view``: an orthographic camera turned about the vertical axis."""
    angle = np.deg2rad(90.0 * view / max(n_views - 1, 1))
    x, y, z = points[..., 0] - 0.5, points[..., 1], points[..., 2] - 0.5
    u = x * np.cos(angle) + z * np.sin(angle) + 0.5
    return np.stack([u * width, y * height], axis=-1)


def write_session(directory: Path, session: str, views: list[str], frames: int, height: int, width: int,
                  seed: int) -> list[Path]:
    """Write ``directory/<session>_<view>.mp4`` for each view (one encoder a
    view, in threads) and return the paths in view order."""
    import cv2

    rng = np.random.default_rng(seed)
    colors = rng.uniform(160, 255, (BLOBS, 3))
    start = rng.uniform(0.35, 0.65, (BLOBS, 3))
    amplitude = rng.uniform(0.15, 0.3, (BLOBS, 3))
    # periods of 1 to 3 seconds: a blob crosses a fifth of the frame in a
    # few frames
    period = rng.uniform(30, 90, (BLOBS, 3))
    phase = rng.uniform(0, 2 * np.pi, (BLOBS, 3))
    t = np.arange(frames)[:, None, None]
    points = start + amplitude * np.sin(2 * np.pi * t / period + phase)
    sigma = SIGMA * width
    r = int(3 * sigma)
    offsets = np.arange(-r, r + 1, dtype=np.float32)
    kernel = np.exp(-(offsets[:, None] ** 2 + offsets[None, :] ** 2) / (2 * sigma**2))
    # BGR, the order that OpenCV writes
    background = np.array(BACKGROUND[::-1], dtype=np.float32)
    blobs = [np.rint(background + kernel[:, :, None] * (c[::-1] - background)).astype(np.uint8) for c in colors]
    blank = np.empty((height + 2 * r, width + 2 * r, 3), dtype=np.uint8)
    blank[:] = background.astype(np.uint8)
    directory.mkdir(parents=True, exist_ok=True)
    paths = [directory / f"{session}_{view}.mp4" for view in views]

    def write(v: int) -> None:
        centers = np.rint(_project(points, v, len(views), height, width)).astype(int)
        writer = cv2.VideoWriter(str(paths[v]), cv2.VideoWriter_fourcc(*"mp4v"), FPS, (width, height))
        if not writer.isOpened():
            raise RuntimeError(f"cannot open a video writer for {paths[v]}")
        try:
            for i in range(frames):
                frame = blank.copy()
                for (x0, y0), blob in zip(centers[i], blobs):
                    if 0 <= x0 < width and 0 <= y0 < height:
                        # the blob's window in padded coordinates
                        patch = frame[y0:y0 + 2 * r + 1, x0:x0 + 2 * r + 1]
                        np.maximum(patch, blob, out=patch)
                writer.write(np.ascontiguousarray(frame[r:r + height, r:r + width]))
        finally:
            writer.release()

    with ThreadPoolExecutor(len(views)) as pool:
        for future in [pool.submit(write, v) for v in range(len(views))]:
            future.result()
    return paths
