"""``litpose-torch`` entry point (counterpart of
``lightning_pose_tpu/cli/main.py``; reference lightning_pose/cli/main.py:58).

Registers the same 8 subcommands: train, predict, export, create_bbox,
smooth_bbox, crop, remap, run_app. Run it as ``litpose-torch`` or
``python -m lightning_pose_tpu_torch.cli.main``. The commands that build a
model run on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import logging
import sys


def _configure_logging(verbose: bool = False) -> None:
    """Package logger configuration (reference cli/main.py:13-24)."""
    level = logging.DEBUG if verbose else logging.INFO
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stdout,
    )


def build_parser() -> argparse.ArgumentParser:
    from lightning_pose_tpu_torch import __version__
    from lightning_pose_tpu_torch.cli import commands
    from lightning_pose_tpu_torch.cli.friendly import ArgumentParser, ArgumentSubParser

    parser = ArgumentParser(
        prog="litpose-torch",
        description=(
            "lightning-pose-tpu, PyTorch/CUDA port: animal pose estimation "
            "(train / predict / export / cropzoom tools)"
        ),
    )
    parser.add_argument("--version", action="version", version=f"lightning-pose-tpu {__version__}")
    parser.add_argument("--verbose", action="store_true", help="debug logging")
    subparsers = parser.add_subparsers(dest="command", required=True, parser_class=ArgumentSubParser)
    for command in commands.COMMANDS:
        command.register_parser(subparsers)
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _configure_logging(getattr(args, "verbose", False))

    # on-startup data migrations, before every command dispatch (reference
    # cli/main.py:74-76)
    from lightning_pose_tpu_torch.cli import commands
    from lightning_pose_tpu_torch.migrations import run_migrations

    run_migrations()

    for command in commands.COMMANDS:
        if command.NAME == args.command:
            command.handle(args)
            return 0
    parser.error(f"unknown command: {args.command}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
