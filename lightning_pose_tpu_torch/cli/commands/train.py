"""``litpose-torch train`` (counterpart of
``lightning_pose_tpu/cli/commands/train.py``; reference
lightning_pose/cli/commands/train.py:21-114)."""

from __future__ import annotations

import argparse
import datetime
import os
from pathlib import Path
from typing import Any

NAME = "train"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME, description="Train a pose estimation model from a config file."
    )
    from lightning_pose_tpu_torch.cli import types as cli_types
    from lightning_pose_tpu_torch.cli.commands import add_device_argument

    p.add_argument(
        "config_file", type=cli_types.config_file,
        help="path to a config yaml file",
    )
    p.add_argument(
        "--output_dir",
        type=Path,
        default=None,
        help="directory to save trained model outputs "
        "(default: ./outputs/<date>/<time>_<model_name>)",
    )
    p.add_argument(
        "--overrides",
        nargs="*",
        default=[],
        metavar="KEY=VALUE",
        help="config overrides, e.g. training.max_epochs=10",
    )
    p.add_argument(
        "--detector_model",
        type=Path,
        default=None,
        help="detector model directory for the cropzoom pipeline; redirects "
        "data paths to the detector's cropped images/videos "
        "(reference cli/commands/train.py:97-114)",
    )
    add_device_argument(p)
    return p


def handle(args: argparse.Namespace) -> None:
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.train import trainer

    cfg = load_config(str(args.config_file), overrides=list(args.overrides))

    if args.detector_model is not None:
        # redirect data to the detector's cropped outputs
        detector_dir = Path(args.detector_model)
        csv_name = Path(cfg.data.csv_file).name
        cfg.data.data_dir = str(detector_dir / "cropped_images")
        cfg.data.video_dir = str(detector_dir / "cropped_videos")
        cfg.data.csv_file = str(
            detector_dir / "image_preds" / csv_name / f"cropped_{csv_name}"
        )

    if args.output_dir:
        output_dir = args.output_dir
    else:
        now = datetime.datetime.now()
        output_dir = Path(
            f"outputs/{now.strftime('%Y-%m-%d')}/"
            f"{now.strftime('%H-%M-%S')}_{cfg.model.model_name}"
        )
    os.makedirs(output_dir, exist_ok=True)
    trainer.train(cfg, model_dir=output_dir, device=args.device)
    print(f"model saved to {output_dir}")
