"""``litpose-torch export`` (counterpart of
``lightning_pose_tpu/cli/commands/export.py``; reference
lightning_pose/cli/commands/export.py:24-90).

The reference exports ONNX; the port saves the prediction program with
``torch.export`` (``Model.export``), its kernels as registered ops.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Any

NAME = "export"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME, description="Export a trained model as a saved torch.export program (exports_torch/predict.pt2)."
    )
    from lightning_pose_tpu_torch.cli import types as cli_types
    from lightning_pose_tpu_torch.cli.commands import add_device_argument

    p.add_argument(
        "model_dir", type=cli_types.existing_model_dir,
        help="trained model directory",
    )
    p.add_argument("--output_dir", type=Path, default=None)
    add_device_argument(p)
    return p


def handle(args: argparse.Namespace) -> None:
    from lightning_pose_tpu_torch.api.model import Model

    model = Model.from_dir(args.model_dir, device=args.device)
    path = model.export(output_dir=args.output_dir)
    print(f"exported to {path}")
