"""``litpose-torch smooth_bbox`` (counterpart of
``lightning_pose_tpu/cli/commands/smooth_bbox.py``; reference
lightning_pose/cli/commands/smooth_bbox.py:13-100)."""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

NAME = "smooth_bbox"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME, description="Temporally smooth bbox CSV files (rolling median)."
    )
    p.add_argument(
        "bbox_dir", type=Path,
        help="directory of raw *_bbox.csv files (output of litpose-torch create_bbox)",
    )
    p.add_argument(
        "--output_dir", type=Path, required=True,
        help="directory for smoothed bbox files and metadata.json",
    )
    p.add_argument("--method", default="median", choices=["median"])
    p.add_argument("--window", type=int, default=5)
    return p


def handle(args: argparse.Namespace) -> None:
    from lightning_pose_tpu_torch.utils import cropzoom as cz

    cz.smooth_bbox(
        args.bbox_dir, args.output_dir, method=args.method, window=args.window
    )
    print(f"wrote smoothed bboxes to {args.output_dir}")
