"""A toy-size rehearsal on the CPU of the video-prediction cell, through
``run.run_cell`` (which the command line does not expose): a sound run
passes its checks; the control (the reference in float8 in the program's
place) and the program with its timed path broken fail them: an answer
altered, half of each batch left out, the rows one frame off, the second
view one frame out of sync, the first batch's answers for every batch.

At this size a batch is 6 windows, so one altered answer a batch is a
sixth of them. At the cell's size it is one in 60; what the check sees
there is read on the card by ``lpbench/control.py``, which plants these
faults in the program's rows at the cell's size: ``kp_q99_ratio`` catches
a fault in more than one answer in a hundred of a view, the medians one in
half of them. No metric of these runs is written anywhere: on the CPU
they measure nothing of the card."""

from __future__ import annotations

import pytest
import torch

from lpbench import compare
from lpbench.run import run_cell

SEED = 2**31 + 11


def _rehearse(cell, monkeypatch=None, fault=None):
    if fault is not None:
        from lightning_pose_tpu_torch.api.model import PredictStep

        monkeypatch.setattr(PredictStep, "forward", fault(PredictStep.forward))
    return run_cell(cell, SEED, 0.5, False, torch.device("cpu"))


def test_sound_run_is_correct(toy_predict_cell):
    out = _rehearse(toy_predict_cell)
    assert out["correct"], out["checks"]
    assert out["run"].attempted >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(compare.NAMES)


def altered_answer(forward):
    """One answer altered where it is produced: each batch's first row of
    keypoints moved 6 model pixels."""
    def wrapped(self, images, bbox):
        kp, conf = forward(self, images, bbox)
        return torch.cat([kp[:1] + 6.0, kp[1:]]), conf
    return wrapped


def half_batch(forward):
    """Half of each batch left out: the rows of its second half are never
    computed and stay as allocated (zeros)."""
    def wrapped(self, images, bbox):
        kp, conf = forward(self, images, bbox)
        half = kp.shape[0] // 2
        return torch.cat([kp[:half], torch.zeros_like(kp[half:])]), torch.cat([conf[:half], torch.zeros_like(conf[half:])])
    return wrapped


def frame_shift(forward):
    """The window-centre remap one frame off: each window's row answers the
    next window's frame (the last repeated)."""
    def wrapped(self, images, bbox):
        kp, conf = forward(self, images, bbox)
        return torch.cat([kp[1:], kp[-1:]]), torch.cat([conf[1:], conf[-1:]])
    return wrapped


def view_desync(forward):
    """The second view one frame out of sync with the first: its keypoints
    (the second half of each row) answer the next window's frame."""
    def wrapped(self, images, bbox):
        kp, conf = forward(self, images, bbox)
        half = kp.shape[1] // 2
        late = torch.cat([kp[1:, half:], kp[-1:, half:]])
        return torch.cat([kp[:, :half], late], dim=1), conf
    return wrapped


def first_batch_tiled(forward):
    """The first batch's answers returned for every batch."""
    first = []

    def wrapped(self, images, bbox):
        if not first:
            first.append(forward(self, images, bbox))
        return first[0]
    return wrapped


FAULTS = [altered_answer, half_batch, frame_shift, view_desync, first_batch_tiled]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(toy_predict_cell, monkeypatch, fault):
    out = _rehearse(toy_predict_cell, monkeypatch, fault)
    assert not out["correct"], out["checks"]


def test_float8_control_is_not_correct(toy_predict_cell, tmp_path):
    from lpbench import harness

    driver = harness.load_module("drivers", "predict_video")
    session = driver.Session(toy_predict_cell, SEED, tmp_path / "w", torch.device("cpu"))
    session.setup()
    session.free_program()
    answers, yardstick, control = driver.reference_answers(
        session, (driver.ref.FP32, driver.ref.BF16, driver.ref.FP8))
    yardstick, control = driver.merged_rows(yardstick), driver.merged_rows(control)
    numbers, bad = compare.video_numbers(control, answers, yardstick)
    assert bad == 0
    correct, checks = compare.judge(numbers, toy_predict_cell.limits)
    assert not correct, checks
    # the reference in its own place agrees with itself
    same, bad = compare.video_numbers(driver.merged_rows(answers), answers, yardstick)
    assert bad == 0 and set(same.values()) == {0.0}
