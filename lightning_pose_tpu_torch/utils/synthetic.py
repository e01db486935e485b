"""Seeded synthetic labeled data for smoke runs and tests.

``write_labeled_dataset`` writes what a labeling project holds: PNG frames
under ``labeled-data/``, a DLC-format ``CollectedData.csv`` (scorer,
bodyparts, coords header rows), and an empty ``videos/`` directory. Each
frame is a dark background with one Gaussian blob per keypoint at its
label, so a model can learn the labels.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = ["write_labeled_dataset"]


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
