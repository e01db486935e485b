"""Custom argparse type validators for CLI path arguments (counterpart of
``lightning_pose_tpu/cli/types.py``; reference lightning_pose/cli/types.py:7-56):
they fail fast with readable errors instead of deep stack traces from the
prediction and training code."""

from __future__ import annotations

import argparse
from pathlib import Path

__all__ = ["config_file", "model_dir", "existing_model_dir"]


def config_file(filepath: str) -> Path:
    """An existing ``.yaml`` config file."""
    path = Path(filepath)
    if not path.is_file():
        raise argparse.ArgumentTypeError(f"File not found: {filepath}")
    if path.suffix != ".yaml":
        raise argparse.ArgumentTypeError(f"File must be a yaml file: {filepath}")
    return path


def model_dir(filepath: str | Path) -> Path:
    return Path(filepath)


def existing_model_dir(filepath: str | Path) -> Path:
    """An existing model directory."""
    path = model_dir(filepath)
    if not path.is_dir():
        raise argparse.ArgumentTypeError(
            f"Directory model_dir does not exist: {filepath}"
        )
    return path
