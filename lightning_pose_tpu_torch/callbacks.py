"""Training and inference progress files (counterpart of the JSON progress
pieces of ``lightning_pose_tpu/callbacks.py``, whose module imports JAX)."""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

__all__ = ["JSONInferenceProgressTracker", "JSONTrainingProgressTracker", "write_status"]


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
