"""The readings that a cell's limits are set from, on the card:

    python3 lpbench/control.py --workload <name> --seeds 1 2 3 ...

For each seed it sets the cell up as a run does, predicts the session once
through the program, frees the program, and compares with the plain
reference (float32, TF32 off), in units of the reference's own bf16
rounding (``lpbench/compare.py``):

- the program's rows: the lower reading of each number;
- the control: the same reference with every convolution's input and
  weight rounded to float8 e4m3, merged as the model merges its heads (the
  upper reading);
- the program's rows with a fault planted in them at the cell's size
  (:data:`FAULTS`), each of which has to read not correct.

One JSON line a seed, with each side's ``motion_ratio``
(``lpbench/compare.py``), how the distances spread and how far the
reference's answers move from frame to frame.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import lpbench  # noqa: E402

lpbench.use_checkout_caches()

from lpbench import compare, harness  # noqa: E402

# the model pixels an altered answer is moved by
NUDGE = 6.0


def _shift(rows: np.ndarray) -> np.ndarray:
    """Each frame's row answers the next frame (the last repeated)."""
    idx = np.minimum(np.arange(rows.shape[-2]) + 1, rows.shape[-2] - 1)
    return rows[..., idx, :]


def frame_shift(rows, batch, scale):
    """The window-centre remap one frame off: every view's rows."""
    return _shift(rows)


def view_desync(rows, batch, scale):
    """The second view one frame out of sync with the first."""
    out = rows.copy()
    out[:, 1] = _shift(rows[:, 1])
    return out


def first_batch_tiled(rows, batch, scale):
    """The first batch's answers for every batch."""
    n = rows.shape[-2]
    return rows[..., np.arange(n) % batch, :]


def tail_batch(rows, batch, scale):
    """The last, padded batch answers as the batch before it."""
    n = rows.shape[-2]
    tail = 2 + (n - 4 - 1) // batch * batch  # the first frame of the last batch's windows
    out = rows.copy()
    out[..., tail:, :] = rows[..., tail - batch:tail - batch + n - tail, :]
    return out


def one_window_a_batch(rows, batch, scale):
    """One window a batch (its first) answers a keypoint position moved
    :data:`NUDGE` model pixels (``scale``: frame pixels a model pixel)."""
    out = rows.copy()
    frames = np.arange(2, rows.shape[-2] - 2, batch)
    out[..., frames, 0::3] += NUDGE * scale[0]
    out[..., frames, 1::3] += NUDGE * scale[1]
    return out


FAULTS = (frame_shift, view_desync, first_batch_tiled, tail_batch, one_window_a_batch)


def spread(rows: np.ndarray, answers: dict, yardstick: np.ndarray) -> dict:
    """How the distances spread: their quartiles and 99th percentile, the
    95th percentile over the yardstick's, the share of keypoints beyond
    0.05, 0.5 and 8 frame pixels, and the largest relative difference of
    likelihood."""
    dist, dlik = compare.distances(rows, answers)
    unit = compare.distances(yardstick, answers)[0]
    out = {f"share_over_{t}px": float((dist > t).mean()) for t in (0.05, 0.5, 8)}
    out["quantiles_px"] = [float(q) for q in np.quantile(dist, [0.25, 0.5, 0.75, 0.99])]
    out["q95_ratio"] = float(np.quantile(dist, 0.95) / max(float(np.quantile(unit, 0.95)), compare.TINY))
    out["lik_quartiles_rel"] = [float(q) for q in np.quantile(dlik, [0.25, 0.5, 0.75])]
    out["lik_max_rel"] = float(dlik.max())
    return out


def signal(answers: dict, merged) -> dict:
    """How much the reference's answers move: the median distance of a
    keypoint from its mean over the session, between frames 1 and 10
    apart (frame pixels), and the median confidence."""
    rows = merged(answers)[0]
    xy = np.stack([rows[..., 0::3], rows[..., 1::3]], axis=-1)
    out = {"temporal_px": float(np.median(np.linalg.norm(xy - xy.mean(axis=1, keepdims=True), axis=-1)))}
    for lag in (1, 10):
        out[f"lag{lag}_px"] = float(np.median(np.linalg.norm(xy[:, lag:] - xy[:, :-lag], axis=-1)))
    out["median_confidence"] = float(np.median(rows[..., 2::3]))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args()
    cell = harness.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("lpbench control: needs a CUDA card", file=sys.stderr)
        return 3
    driver = harness.load_module("drivers", cell.mix["driver"])
    card = harness.card_line()
    for seed in args.seeds:
        t0 = time.perf_counter()
        session = driver.Session(cell, seed, Path(tempfile.gettempdir()) / "lpbench" / cell.name,
                                 torch.device("cuda", 0))
        try:
            session.setup()
            session.outputs = [session.call()]
            rows = np.stack(session.outputs + [session.last_csvs()])
            session.free_program()
            answers, yardstick, control = driver.reference_answers(
                session, (driver.ref.FP32, driver.ref.BF16, driver.ref.FP8))
            yardstick, control = driver.merged_rows(yardstick), driver.merged_rows(control)
        finally:
            session.cleanup()
        program, bad = compare.video_numbers(rows, answers, yardstick)
        fp8, _ = compare.video_numbers(control, answers, yardstick)
        batch = session.seq_len - 4
        scale = (session.raw_w / session.width, session.raw_h / session.height)
        faults = {}
        for fault in FAULTS:
            faulty = fault(rows, batch, scale)
            numbers, _ = compare.video_numbers(faulty, answers, yardstick)
            faults[fault.__name__] = dict(numbers, correct=compare.judge(numbers, cell.limits)[0],
                                          motion_ratio=compare.motion_ratio(faulty, answers))
        program["motion_ratio"] = compare.motion_ratio(rows, answers)
        fp8["motion_ratio"] = compare.motion_ratio(control, answers)
        print(json.dumps({"seed": seed, "card": card, "program": program, "malformed": bad, "control_fp8": fp8,
                          "faults": faults, "seconds": time.perf_counter() - t0, "phases": session.phases,
                          "signal": signal(answers, driver.merged_rows),
                          "spread": {"program": spread(rows, answers, yardstick),
                                     "control_fp8": spread(control, answers, yardstick),
                                     "yardstick_bf16": spread(yardstick, answers, yardstick)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
