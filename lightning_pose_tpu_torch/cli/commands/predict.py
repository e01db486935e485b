"""``litpose-torch predict`` (counterpart of
``lightning_pose_tpu/cli/commands/predict.py``; reference
lightning_pose/cli/commands/predict.py:35-266)."""

from __future__ import annotations

import argparse
import logging
from pathlib import Path
from typing import Any

logger = logging.getLogger(__name__)

NAME = "predict"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME,
        description=(
            "Predict on videos, image directories, or labeled CSV files using "
            "a trained model. Videos -> video_preds/<stem>.csv; CSVs -> "
            "image_preds/<csv>/predictions.csv."
        ),
    )
    from lightning_pose_tpu_torch.cli import types as cli_types

    p.add_argument(
        "model_dir", type=cli_types.existing_model_dir,
        help="trained model directory",
    )
    p.add_argument(
        "input_path",
        type=Path,
        nargs="+",
        help="video file(s), CSV file(s), or a directory of videos",
    )
    p.add_argument("--output_dir", type=Path, default=None)
    p.add_argument("--overrides", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument(
        "--overwrite", action="store_true", help="overwrite existing predictions"
    )
    p.add_argument(
        "--skip_viz", action="store_true", help="skip labeled-video generation"
    )
    p.add_argument(
        "--compile", action="store_true",
        help="torch.compile the prediction program before running",
    )
    p.add_argument(
        "--precision", default=None, choices=["fp32", "fp16", "bf16"],
        help="compute precision (default bf16; fp16 maps to bf16)",
    )
    p.add_argument(
        "--bbox_dir", type=Path, default=None,
        help="directory of per-video <stem>_bbox.csv files for bbox-crop "
        "inference (the cropzoom pipeline)",
    )
    p.add_argument(
        "--runtime", choices=["eager", "exported"], default="eager",
        help="inference backend: 'eager' runs the trained checkpoint; "
        "'exported' runs the torch.export program written by "
        "`litpose-torch export` (the reference's --runtime onnx analog; video "
        "inputs only: the export has fixed batch shapes)",
    )
    p.add_argument(
        "--data_parallel", action="store_true",
        help="split inference batches across all visible GPUs, one replica "
        "of the model each (eager runtime only)",
    )
    # app support: JSON progress file updated per batch (reference
    # --progress_file, cli/commands/predict.py:160-167)
    p.add_argument("--progress_file", type=Path, help=argparse.SUPPRESS)
    from lightning_pose_tpu_torch.cli.commands import add_device_argument

    add_device_argument(p)
    return p


def handle(args: argparse.Namespace) -> None:
    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.utils.io import check_video_paths

    model = Model.from_dir2(
        args.model_dir, hydra_overrides=list(args.overrides),
        precision=args.precision,
        device=args.device,
        data_parallel=getattr(args, "data_parallel", False),
    )
    if getattr(args, "runtime", "eager") == "exported":
        if getattr(args, "data_parallel", False):
            raise ValueError(
                "--data_parallel applies to the eager runtime only (the "
                "exported program has fixed single-device input shapes)"
            )
        if any(Path(p).suffix == ".csv" for p in args.input_path):
            raise ValueError(
                "--runtime exported serves video inputs only (the export "
                "has fixed batch shapes); use the eager runtime for CSVs"
            )
        model.use_exported_runtime()
    if args.compile:
        model.compile()

    if model.config.is_multi_view():
        _predict_multiview(model, args)
        return

    inputs = []
    for input_path in args.input_path:
        input_path = Path(input_path)
        if input_path.is_dir():
            inputs += [Path(f) for f in check_video_paths(str(input_path))]
        else:
            inputs.append(input_path)

    for input_path in inputs:
        _predict_one(model, input_path, args)


def _predict_multiview(model, args: argparse.Namespace) -> None:
    """Group per-view inputs by session for multiview models
    (reference cli/commands/predict.py multiview session grouping)."""
    from lightning_pose_tpu_torch.utils.io import (
        find_video_files_for_views,
        split_video_files_by_view,
    )

    view_names = list(model.cfg.data.view_names)
    paths = [Path(p) for p in args.input_path]

    csvs = [p for p in paths if p.suffix == ".csv"]
    if csvs:
        if len(csvs) != len(view_names):
            raise ValueError(
                f"multiview models need one CSV per view ({len(view_names)}), "
                f"got {len(csvs)}"
            )
        model.predict_on_label_csv_multiview(csv_file_per_view=[str(c) for c in csvs])

    videos = [p for p in paths if p.suffix == ".mp4"]
    dirs = [p for p in paths if p.is_dir()]
    sessions = []
    if videos:
        sessions += split_video_files_by_view(videos, view_names)
    for d in dirs:
        sessions += find_video_files_for_views(str(d), view_names)
    for session_videos in sessions:
        # per-session skip-existing, as the reference predict does
        # (reference cli/commands/predict.py:315-326)
        if not args.overwrite and all(
            (model.video_preds_dir() / (Path(v).stem + ".csv")).exists()
            for v in session_videos
        ):
            logger.info(
                f"skipping session {Path(session_videos[0]).stem} "
                "(predictions exist; use --overwrite)"
            )
            continue
        model.predict_on_video_file_multiview(
            video_file_per_view=[str(v) for v in session_videos],
            generate_labeled_video=not args.skip_viz,
            output_dir=args.output_dir,
            progress_file=getattr(args, "progress_file", None),
        )


def _predict_one(model, input_path: Path, args: argparse.Namespace) -> None:
    if input_path.suffix == ".mp4":
        preds_file = model.video_preds_dir() / (input_path.stem + ".csv")
        if preds_file.exists() and not args.overwrite:
            logger.info(f"skipping {input_path} (predictions exist; use --overwrite)")
            return
        bbox_df = None
        if args.bbox_dir is not None:
            import pandas as pd

            bbox_file = args.bbox_dir / (input_path.stem + "_bbox.csv")
            if bbox_file.exists():
                bbox_df = pd.read_csv(bbox_file, index_col=0)
            else:
                logger.warning(f"no bbox file {bbox_file}; full-frame predict")
        model.predict_on_video_file(
            input_path,
            generate_labeled_video=not args.skip_viz,
            output_dir=args.output_dir,
            bbox_df=bbox_df,
            progress_file=getattr(args, "progress_file", None),
        )
    elif input_path.suffix == ".csv":
        preds_file = model.image_preds_dir() / input_path.name / "predictions.csv"
        if preds_file.exists() and not args.overwrite:
            logger.info(f"skipping {input_path} (predictions exist; use --overwrite)")
            return
        # CSV inputs read <bbox_dir>/bbox.csv (reference predict.py:269-272)
        bbox_file = None
        if args.bbox_dir is not None:
            bbox_file = args.bbox_dir / "bbox.csv"
            if not bbox_file.exists():
                raise FileNotFoundError(
                    f"--bbox_dir given but {bbox_file} does not exist; run "
                    "`litpose-torch create_bbox` (or `litpose-torch smooth_bbox`) first"
                )
        model.predict_on_label_csv(
            input_path, output_dir=args.output_dir, bbox_file=bbox_file
        )
    else:
        raise ValueError(f"unsupported input type: {input_path}")
