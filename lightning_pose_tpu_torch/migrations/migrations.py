"""Data-directory migrations run by the CLI at startup (counterpart of
``lightning_pose_tpu/migrations/migrations.py``; reference
lightning_pose/migrations/migrations.py:11-65).

Currently: ``rename_time_directories`` — old App layouts used
``HH:MM:SS``-style directory names that break on some filesystems; rename
to ``HH-MM-SS``.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path

logger = logging.getLogger(__name__)

__all__ = ["run_migrations", "rename_time_directories"]


def rename_time_directories(root: str | Path) -> int:
    """Rename ``HH:MM:SS`` output directories to ``HH-MM-SS``; returns count."""
    root = Path(root)
    count = 0
    if not root.exists():
        return count
    pattern = re.compile(r"^(\d{2}):(\d{2}):(\d{2})$")
    for dirpath, dirnames, _ in os.walk(root, topdown=False):
        for d in dirnames:
            m = pattern.match(d)
            if m:
                src = Path(dirpath) / d
                dst = Path(dirpath) / f"{m.group(1)}-{m.group(2)}-{m.group(3)}"
                if not dst.exists():
                    src.rename(dst)
                    count += 1
                    logger.info(f"migrated {src} -> {dst}")
    return count


def run_migrations(data_dir: str | Path | None = None) -> None:
    """Run all registered migrations (reference migrations.py:11)."""
    if data_dir is None:
        data_dir = os.getcwd()
    rename_time_directories(Path(data_dir) / "outputs")
