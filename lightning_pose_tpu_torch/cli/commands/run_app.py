"""``litpose-torch run_app`` (counterpart of
``lightning_pose_tpu/cli/commands/run_app.py``; reference
lightning_pose/cli/commands/run_app.py:10-50).

The reference delegates to the external ``litpose_app`` package; so does
this command, when that package is installed.
"""

from __future__ import annotations

import argparse
from typing import Any

NAME = "run_app"


def register_parser(subparsers: Any) -> argparse.ArgumentParser:
    p = subparsers.add_parser(
        NAME, description="Run the Lightning Pose labeling/analysis app."
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    return p


def handle(args: argparse.Namespace) -> None:
    try:
        import litpose_app  # noqa: F401
    except ImportError:
        raise SystemExit(
            "the app requires the external `lightning-pose-app` package; "
            "install it with `pip install lightning-pose-app`"
        )
    from litpose_app import main as app_main  # type: ignore[import-not-found]

    app_main(host=args.host, port=args.port)
