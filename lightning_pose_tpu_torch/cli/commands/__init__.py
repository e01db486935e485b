"""CLI subcommand registry (counterpart of
``lightning_pose_tpu/cli/commands/__init__.py``; reference
lightning_pose/cli/commands/__init__.py:6-15)."""

from lightning_pose_tpu_torch.cli.commands import (
    create_bbox,
    crop,
    export,
    predict,
    remap,
    run_app,
    smooth_bbox,
    train,
)

COMMANDS = [
    train,
    predict,
    export,
    create_bbox,
    smooth_bbox,
    crop,
    remap,
    run_app,
]


def add_device_argument(parser) -> None:
    """``--device``: where the command's model runs (default ``cuda``; there
    is no fallback to the CPU)."""
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of the model: cuda (default), cuda:N, or cpu",
    )
