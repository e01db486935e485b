"""The program's own host spans in a capture (``lp.*``, opened by
``lightning_pose_tpu_torch/utils/tracing.py`` inside the predict path).

The capture records the thread that opened :data:`lpbench.trace.WINDOW`,
the thread that calls the program: its spans are the loop's, and no two of
them overlap. The spans' readers name them by their literal names, so a
span renamed in the program reads as missing.
"""

from __future__ import annotations

from lpbench.trace import WINDOW, Trace

__all__ = ["loop_spans", "seconds"]


def loop_spans(trace: Trace, name: str) -> list[dict]:
    """The spans ``name`` of the window's thread that start inside the
    window, sorted by start."""
    lo, hi = trace.window()
    tid = next(e["tid"] for e in trace.events if e.get("name") == WINDOW and e.get("cat") == "user_annotation")
    return sorted((e for e in trace.events if e.get("name") == name and e.get("cat") == "user_annotation"
                   and e.get("ph") == "X" and e.get("tid") == tid and lo <= float(e["ts"]) < hi),
                  key=lambda e: float(e["ts"]))


def seconds(spans: list[dict]) -> float:
    """The spans' summed durations (s)."""
    return sum(float(e["dur"]) for e in spans) * 1e-6
