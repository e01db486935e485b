"""Friendlier argparse behavior for the ``litpose-torch`` CLI (counterpart of
``lightning_pose_tpu/cli/friendly.py``; reference
lightning_pose/cli/friendly.py:9-89).

Three quality-of-life changes over stock argparse:

- top-level ``--help`` opens with a short welcome banner;
- argument errors print the relevant usage/help before the error message
  instead of the terse two-line default;
- help text preserves paragraph breaks and explicit newlines (stock
  argparse re-wraps everything into one block).
"""

from __future__ import annotations

import argparse
import sys
import textwrap
from typing import Any

WELCOME = (
    "Welcome to lightning-pose-tpu! Animal pose estimation, PyTorch/CUDA port.\n"
    "Docs: see docs/user_guide.md in the repository.\n"
)


class _ParagraphFormatter(argparse.HelpFormatter):
    """Keeps blank-line paragraph structure in help strings."""

    def _split_lines(self, text: str, width: int) -> list[str]:
        lines: list[str] = []
        for para in text.split("\n"):
            if not para:
                lines.append("")
                continue
            lines.extend(textwrap.wrap(para, width))
        return lines

    def _fill_text(self, text: str, width: int, indent: str) -> str:
        paras = []
        for para in text.split("\n\n"):
            paras.append(
                textwrap.fill(
                    " ".join(para.split()), width,
                    initial_indent=indent, subsequent_indent=indent,
                )
            )
        return "\n\n".join(paras)


class ArgumentParser(argparse.ArgumentParser):
    """Top-level parser: welcome banner + help-before-error."""

    def __init__(self, **kwargs: Any) -> None:
        kwargs.setdefault("formatter_class", _ParagraphFormatter)
        super().__init__(**kwargs)

    def print_help(self, file=None, with_welcome: bool = True) -> None:
        if with_welcome:
            print(WELCOME, file=file or sys.stdout)
        super().print_help(file)

    def error(self, message: str) -> None:
        """Show usage + help before the error (stock argparse prints only
        a two-line usage/error pair)."""
        self.print_help(sys.stderr, with_welcome=False)
        self.exit(2, f"\n{self.prog}: error: {message}\n")


class ArgumentSubParser(ArgumentParser):
    """Subcommand parser: same error behavior, no welcome banner."""

    def print_help(self, file=None, with_welcome: bool = False) -> None:
        super().print_help(file, with_welcome=with_welcome)
