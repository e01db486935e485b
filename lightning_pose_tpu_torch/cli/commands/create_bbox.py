"""``litpose-torch create_bbox`` (counterpart of
``lightning_pose_tpu/cli/commands/create_bbox.py``; reference
lightning_pose/cli/commands/create_bbox.py:21-176).

Computes per-frame bounding boxes from detector-model predictions (run
``litpose-torch predict`` first). Outputs follow the reference conventions:
videos -> ``<model_dir>/video_preds/<stem>_bbox.csv``; labeled CSVs ->
``<model_dir>/image_preds/<csv_name>/bbox.csv``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

NAME = "create_bbox"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME,
        description=(
            "Compute per-frame bounding boxes from detector-model predictions "
            "(first stage of the cropzoom pipeline; run `litpose-torch predict` "
            "first). Videos -> video_preds/<stem>_bbox.csv; labeled CSVs -> "
            "image_preds/<csv>/bbox.csv. Optionally smooth with "
            "`litpose-torch smooth_bbox` before `litpose-torch crop`."
        ),
        usage=(
            "litpose-torch create_bbox <model_dir> <input_path:video|csv>..."
            " [--crop_ratio=CROP_RATIO | --crop_size=CROP_SIZE]"
            " [--anchor_keypoints=x,y,z]"
        ),
    )
    from lightning_pose_tpu_torch.cli import types as cli_types

    p.add_argument(
        "model_dir", type=cli_types.existing_model_dir,
        help="path to a detector model directory",
    )
    p.add_argument(
        "input_path", type=Path, nargs="+",
        help="video file(s), CSV file(s), or directories (directories expand "
        "to their contained *.mp4 files)",
    )
    p.add_argument(
        "--crop_ratio", type=float, default=None,
        help="size the bbox this many times the animal keypoint span "
        "(default 2.0 when neither flag is given). Mutually exclusive with "
        "--crop_size.",
    )
    p.add_argument(
        "--crop_size", type=int, default=None,
        help="fixed square bbox side length in pixels, centered on the "
        "per-frame mean of the anchor keypoints. Mutually exclusive with "
        "--crop_ratio.",
    )
    p.add_argument(
        "--anchor_keypoints", type=str, default="",
        help="comma-separated anchor keypoint names (default: all keypoints)",
    )
    from lightning_pose_tpu_torch.cli.commands import add_device_argument

    add_device_argument(p)
    return p


def handle(args: argparse.Namespace) -> None:
    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.config import Config
    from lightning_pose_tpu_torch.utils import cropzoom as cz

    model = Model.from_dir(args.model_dir, device=args.device)

    crop_ratio = args.crop_ratio
    crop_size = args.crop_size
    if crop_ratio is not None and crop_size is not None:
        raise ValueError("--crop_ratio and --crop_size are mutually exclusive.")
    if crop_ratio is None and crop_size is None:
        crop_ratio = 2.0  # reference default (create_bbox.py:131)

    anchor_keypoints = (
        args.anchor_keypoints.split(",") if args.anchor_keypoints else []
    )
    if crop_size is not None:
        if crop_size <= 0:
            raise ValueError(
                f"--crop_size must be a positive integer, got {crop_size}."
            )
        detector_cfg = Config(
            {
                "crop_height": crop_size,
                "crop_width": crop_size,
                "anchor_keypoints": anchor_keypoints,
            }
        )
    else:
        if crop_ratio <= 1:
            raise ValueError(
                f"--crop_ratio must be greater than 1, got {crop_ratio}."
            )
        detector_cfg = Config(
            {"crop_ratio": crop_ratio, "anchor_keypoints": anchor_keypoints}
        )

    input_paths: list[Path] = []
    for p in args.input_path:
        p = Path(p)
        if p.is_dir():
            input_paths.extend(sorted(f for f in p.iterdir() if f.suffix == ".mp4"))
        else:
            input_paths.append(p)

    for input_path in input_paths:
        if input_path.suffix == ".mp4":
            input_preds_file = model.video_preds_dir() / (input_path.stem + ".csv")
            output_bbox_file = model.video_preds_dir() / (
                input_path.stem + "_bbox.csv"
            )
        elif input_path.suffix == ".csv":
            preds_dir = model.image_preds_dir() / input_path.name
            input_preds_file = preds_dir / "predictions.csv"
            output_bbox_file = preds_dir / "bbox.csv"
        else:
            raise NotImplementedError("only mp4 and csv files are supported.")
        logger.info(f"creating bboxes for {input_path.name}")
        cz.generate_bbox(
            input_preds_file=input_preds_file,
            detector_cfg=detector_cfg,
            output_bbox_file=output_bbox_file,
        )
        print(f"wrote {output_bbox_file}")
