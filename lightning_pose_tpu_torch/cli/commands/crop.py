"""``litpose-torch crop`` (counterpart of
``lightning_pose_tpu/cli/commands/crop.py``; reference
lightning_pose/cli/commands/crop.py:19-165).

Crops videos / labeled frames with pre-computed bboxes (run
``litpose-torch create_bbox`` first, optionally ``litpose-torch smooth_bbox``).
Outputs follow the reference conventions: videos ->
``<model_dir>/cropped_videos/cropped_<name>.mp4``; labeled CSVs ->
``<model_dir>/cropped_images/...`` + ``image_preds/<csv>/cropped_<csv>``.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

NAME = "crop"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME,
        description=(
            "Crop a video or labeled frames using pre-computed bounding boxes "
            "(run `litpose-torch create_bbox` first). Cropped videos -> "
            "cropped_videos/cropped_<name>.mp4; cropped images -> "
            "cropped_images/ plus a remapped CSV under image_preds/<csv>/. "
            "--bbox_dir overrides the default bbox locations (e.g. the "
            "output of `litpose-torch smooth_bbox`)."
        ),
        usage="litpose-torch crop <model_dir> <input_path:video|csv>... [--bbox_dir=BBOX_DIR]",
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
        "--bbox_dir", type=Path, default=None,
        help="directory of bbox CSVs to use (videos: <stem>_bbox.csv; CSVs: "
        "bbox.csv). Defaults to the locations written by litpose-torch create_bbox.",
    )
    from lightning_pose_tpu_torch.cli.commands import add_device_argument

    add_device_argument(p)
    return p


def handle(args: argparse.Namespace) -> None:
    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.utils import cropzoom as cz

    model = Model.from_dir(args.model_dir, device=args.device)
    # create both dirs up front: the downstream pose-model training config
    # points data_dir/video_dir at them and io validation requires both
    # (reference crop.py:112-118)
    model.cropped_data_dir().mkdir(parents=True, exist_ok=True)
    model.cropped_videos_dir().mkdir(parents=True, exist_ok=True)
    bbox_dir = args.bbox_dir

    input_paths: list[Path] = []
    for p in args.input_path:
        p = Path(p)
        if p.is_dir():
            input_paths.extend(sorted(f for f in p.iterdir() if f.suffix == ".mp4"))
        else:
            input_paths.append(p)

    for input_path in input_paths:
        if input_path.suffix == ".mp4":
            if bbox_dir is not None:
                input_bbox_file = bbox_dir / (input_path.stem + "_bbox.csv")
            else:
                input_bbox_file = model.video_preds_dir() / (
                    input_path.stem + "_bbox.csv"
                )
            output_file = model.cropped_videos_dir() / (
                "cropped_" + input_path.name
            )
            logger.info(f"cropping {input_path.name}")
            cz.crop_video(
                input_video_file=input_path,
                input_bbox_file=input_bbox_file,
                output_file=output_file,
            )
            print(f"wrote {output_file}")
        elif input_path.suffix == ".csv":
            preds_dir = model.image_preds_dir() / input_path.name
            input_data_dir = Path(model.cfg.data.data_dir)
            if bbox_dir is not None:
                input_bbox_file = bbox_dir / "bbox.csv"
            else:
                input_bbox_file = preds_dir / "bbox.csv"
            output_csv_file = preds_dir / ("cropped_" + input_path.name)
            logger.info(f"cropping {input_path.name}")
            cz.crop_labeled_frames(
                input_data_dir=input_data_dir,
                input_csv_file=input_path,
                input_bbox_file=input_bbox_file,
                output_data_dir=model.cropped_data_dir(),
                output_csv_file=output_csv_file,
            )
            print(f"wrote {output_csv_file}")
        else:
            raise NotImplementedError("only mp4 and csv files are supported.")
