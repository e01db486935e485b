"""Training and inference progress files, and the multiview transformer's
patch masking (counterpart of ``lightning_pose_tpu/callbacks.py``, whose
module imports JAX).

Patch masking (the reference's PatchMasker, "simulated occlusions") zeroes a
curriculum fraction of each view image's 16x16 patches in the train step,
after augmentation and before normalization, so a masked patch normalizes
to ``-mean / std``.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "JSONInferenceProgressTracker",
    "JSONTrainingProgressTracker",
    "PATCH_SIZE",
    "apply_patch_mask",
    "patch_mask_ratio",
    "write_status",
]

# the side of a masked patch: the ported ViTs' patch size
PATCH_SIZE = 16


def patch_mask_ratio(
    step: int,
    init_ratio: float = 0.0,
    final_ratio: float = 0.5,
    start_step: int = 0,
    end_step: int = 1,
) -> float:
    """The masked fraction at ``step``: 0 before ``start_step``, then
    ``init_ratio`` ramping linearly to ``final_ratio`` at ``end_step``. In
    float32, as the JAX package computes it, so that the count of masked
    patches floors the same."""
    if step < start_step:
        return 0.0
    span = np.float32(max(end_step - start_step, 1))
    frac = np.clip(np.float32(step - start_step) / span, np.float32(0.0), np.float32(1.0))
    return float(np.float32(init_ratio) + frac * np.float32(final_ratio - init_ratio))


def apply_patch_mask(images: torch.Tensor, ratio: float, scores: torch.Tensor) -> torch.Tensor:
    """Zero ``floor(ratio * P)`` of the ``P`` PATCH_SIZE-square patches of
    each ``(N, H, W, C)`` image: the patches of the lowest ``scores`` ``(N,
    P)`` (uniform draws, patches row-major), thresholded at the order
    statistic as the JAX package does, so its scores give its mask."""
    n, h, w, _ = images.shape
    gh, gw = h // PATCH_SIZE, w // PATCH_SIZE
    num_patches = gh * gw
    n_mask = int(np.floor(np.float32(ratio) * np.float32(num_patches)))
    if n_mask <= 0:
        return images
    if n_mask >= num_patches:
        return images * 0
    thresh = torch.sort(scores, dim=-1).values[:, n_mask]
    keep = (scores >= thresh[:, None]).reshape(n, gh, gw)
    # nearest-neighbour from the patch grid to the pixels
    rows = torch.div(torch.arange(h, device=images.device) * gh, h, rounding_mode="floor")
    cols = torch.div(torch.arange(w, device=images.device) * gw, w, rounding_mode="floor")
    keep = keep[:, rows][:, :, cols]
    return images * keep[..., None].to(images.dtype)


def _atomic_write_json(path: Path, payload: dict) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)


def write_status(path: str | Path, status: str, **extra) -> None:
    """Atomically write ``{"status": status, **extra}`` (``train_status.json``)."""
    _atomic_write_json(Path(path), {"status": status, **extra})


class JSONTrainingProgressTracker:
    """Atomic-write training progress JSON, the schema the LP App reads."""

    def __init__(self, status_file: str | Path | None, total_epochs: int) -> None:
        # None disables writes
        self.status_file = Path(status_file) if status_file is not None else None
        self.total_epochs = total_epochs

    def update(self, epoch: int, extra: dict | None = None) -> None:
        if self.status_file is None:
            return
        _atomic_write_json(
            self.status_file,
            {
                "status": "TRAINING",
                "current_epoch": int(epoch),
                "total_epochs": int(self.total_epochs),
                "progress": round(100.0 * (epoch + 1) / max(self.total_epochs, 1), 2),
                **(extra or {}),
            },
        )


class JSONInferenceProgressTracker:
    """Atomic-write inference progress JSON with the reference's schema
    ``{"completed": N, "total": T, "timestamp": ...}``, which the LP App
    reads (reference callbacks.py:454-525)."""

    def __init__(self, status_file: str | Path, total_batches: int) -> None:
        self.status_file = Path(status_file)
        self.total_batches = max(int(total_batches), 1)
        self._n = 0
        os.makedirs(os.path.dirname(self.status_file) or ".", exist_ok=True)
        self._save()

    def _save(self) -> None:
        _atomic_write_json(
            self.status_file,
            {"completed": self._n, "total": self.total_batches, "timestamp": time.time()},
        )

    def step(self) -> None:
        self._n += 1
        self._save()
