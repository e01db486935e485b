"""The compared numbers of ``lpbench/compare.py`` on hand-made answers:
keypoints that move one pixel a frame, rows that match them to a rounding,
and rows one frame off, in one view or in both."""

from __future__ import annotations

import numpy as np
import pytest

from lpbench import compare

V, N, K = 2, 40, 3


def _answers() -> dict:
    """Both heads answer alike: keypoint k of view v at x = f + 10 k + 5 v
    on frame f (one pixel a frame), confidences 0.5."""
    f = np.arange(N, dtype=np.float64)[None, :, None]
    x = f + 10.0 * np.arange(K)[None, None, :] + 5.0 * np.arange(V)[:, None, None]
    xy = np.stack([x, np.full_like(x, 20.0)], axis=-1)
    conf = np.full((V, N, K), 0.5)
    return {"xy_sf": xy, "xy_mf": xy, "conf_sf": conf, "conf_mf": conf}


def _rows(answers: dict, dx) -> np.ndarray:
    """One call's rows ``(1, V, N, 3K)`` at the answers moved by ``dx``."""
    xy = answers["xy_sf"].copy()
    xy[..., 0] += dx
    lik = answers["conf_sf"] * (1 + 1e-3)
    return np.concatenate([xy, lik[..., None]], axis=-1).reshape(V, N, 3 * K)[None]


@pytest.fixture
def readings():
    answers = _answers()
    rng = np.random.default_rng(0)
    yardstick = _rows(answers, rng.normal(0, 0.01, (V, N, K)))
    sound = _rows(answers, rng.normal(0, 0.01, (V, N, K)))
    return answers, yardstick, sound


def test_motion_is_each_keypoints_median_step(readings):
    answers, _, _ = readings
    np.testing.assert_allclose(compare.motion(answers), np.ones((V, K)))


def test_a_sound_call_reads_about_one_yardstick(readings):
    answers, yardstick, sound = readings
    numbers, bad = compare.video_numbers(sound, answers, yardstick)
    assert bad == 0 and set(numbers) == set(compare.NAMES)
    assert 0.3 < numbers["kp_median_ratio"] < 3 and 0.3 < numbers["kp_q99_ratio"] < 3
    assert compare.motion_ratio(sound, answers) < 0.05


@pytest.mark.parametrize("views", [[0, 1], [1]], ids=["both_views", "one_view"])
def test_rows_one_frame_off_read_one_motion(readings, views):
    answers, yardstick, sound = readings
    shifted = sound.copy()
    for v in views:
        shifted[0, v, :-1] = sound[0, v, 1:]
    numbers, _ = compare.video_numbers(shifted, answers, yardstick)
    assert compare.motion_ratio(shifted, answers) == pytest.approx(1.0, abs=0.05)
    assert numbers["kp_median_ratio"] > 50


def test_a_fault_in_two_answers_a_hundred_moves_only_the_q99(readings):
    answers, yardstick, sound = readings
    faulty = sound.copy()
    faulty[0, 0, :1, 0::3] += 6.0  # one frame of 40, all keypoints: 2.5% of a view
    numbers, _ = compare.video_numbers(faulty, answers, yardstick)
    clean, _ = compare.video_numbers(sound, answers, yardstick)
    assert numbers["kp_q99_ratio"] > 50 * clean["kp_q99_ratio"]
    assert numbers["kp_median_ratio"] == pytest.approx(clean["kp_median_ratio"], rel=0.2)


def test_misshapen_or_missing_rows_fail(readings):
    answers, yardstick, sound = readings
    numbers, bad = compare.video_numbers(sound[..., :-3], answers, yardstick)
    assert bad == 1 and all(np.isinf(list(numbers.values())))
    holed = sound.copy()
    holed[0, 1, 3, 0] = np.nan
    _, bad = compare.video_numbers(holed, answers, yardstick)
    assert bad == 1


def test_judge_fails_a_number_over_or_without_its_limit():
    limits = {"a": {"limit": 1.0}}
    assert compare.judge({"a": 1.0}, limits)[0]
    assert not compare.judge({"a": 1.5}, limits)[0]
    ok, checks = compare.judge({"a": 0.5, "b": 0.1}, limits)
    assert not ok and checks["b"] == {"value": 0.1, "limit": None}
