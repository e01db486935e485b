"""The command line's refusals: an unknown cell, and no card."""

from __future__ import annotations

import subprocess
import sys

import pytest

from lpbench import harness

RUN = [sys.executable, str(harness.LPBENCH / "run.py")]


def _run(*args):
    return subprocess.run([*RUN, *args], capture_output=True, text=True, timeout=300, cwd=harness.ROOT)


def test_unknown_workload_exits_2_with_no_result():
    out = _run("--workload", "no.such.cell", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


def test_without_a_card_it_exits_3_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = _run("--workload", "ctx2v.predict_video", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert out.returncode == 3 and out.stdout == ""
    assert "needs 1 CUDA device" in out.stderr
