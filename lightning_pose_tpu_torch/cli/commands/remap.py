"""``litpose-torch remap`` (counterpart of
``lightning_pose_tpu/cli/commands/remap.py``; reference
lightning_pose/cli/commands/remap.py:9-60).

Remaps cropped-space predictions back to original coordinates by adding
bbox offsets.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

NAME = "remap"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME,
        description="Remap cropped-space predictions to original coordinates.",
    )
    p.add_argument("preds_file", type=Path, help="path to a prediction file")
    p.add_argument("bbox_file", type=Path, help="path to a bbox file")
    p.add_argument("--output_file", type=Path, default=None)
    return p


def handle(args: argparse.Namespace) -> None:
    from lightning_pose_tpu_torch.utils import cropzoom as cz

    out = args.output_file or args.preds_file.with_name(
        "remapped_" + args.preds_file.name
    )
    cz.generate_cropped_csv_file(
        input_csv_file=args.preds_file,
        input_bbox_file=args.bbox_file,
        output_csv_file=out,
        mode="add",
    )
    print(f"wrote {out}")
