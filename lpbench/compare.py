"""The comparisons that decide ``correct``, and their limits.

Video prediction (``video_numbers``): every row that every call of the
window returned, and the CSVs the last call left on disk, against the plain
reference's answers for the same frames.

The context model answers each keypoint with the head (single-frame or
multi-frame) of higher confidence. Where the two heads' confidences lie
within ``CONF_MARGIN`` of each other (relative), rounding may pick either,
so both heads are *eligible* there; elsewhere only the more confident one
is. The program's keypoint is held to the nearest eligible head's answer,
and its likelihood to the higher confidence.

The seeded weights (``lpbench/weights.py``) make every keypoint follow the
moving blobs of the synthetic session (``lpbench/synth.py``): a keypoint
moves some tenths of a model pixel a frame, and bf16 rounding moves it some
thousandths. So a row that answers another frame, or another view's frame,
reads hundreds of times a sound row's distance. How far rounding moves the
keypoints still differs from seed to seed, so the program's distances are
measured against a yardstick computed by the reference from the same
inputs: its own answers with every convolution rounded to bf16, as serving
in bf16 rounds them (``lpbench.reference.model.BF16``).

Each number is taken over every keypoint of every frame of one view in one
call, and the largest over the calls and views is compared:

- ``kp_median_ratio``: the median distance in frame pixels from the nearest
  eligible head's answer, over the yardstick's median distance in that
  view; a fault in half of a view's answers moves it (a view out of sync,
  rows remapped one frame off, one batch's answers for every batch);
- ``kp_q99_ratio``: the same with the 99th percentiles, which a fault in
  more than one answer in a hundred moves (the padded tail batch of a
  video, one bad window a batch, the edge frames' remap);
- ``lik_median_ratio``: the median difference of likelihood from the
  higher confidence, over the yardstick's.

``motion_ratio`` (a reading of ``lpbench/control.py``, not compared) is
the median distance in units of the reference's own motion, each
keypoint's median step between neighbouring frames: a row that answers a
neighbouring frame reads about 1. Its sound readings swing with how fast a
seed's keypoints move, which the yardstick's do not.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CONF_MARGIN", "NAMES", "distances", "eligible", "judge", "motion", "motion_ratio", "video_numbers"]

CONF_MARGIN = 0.05
TINY = 1e-12
NAMES = ("kp_median_ratio", "kp_q99_ratio", "lik_median_ratio")


def eligible(ref: dict) -> tuple[np.ndarray, np.ndarray]:
    """Where each head (single-frame, multi-frame) may answer a keypoint."""
    top = np.maximum(ref["conf_sf"], ref["conf_mf"])
    close = np.abs(ref["conf_mf"] - ref["conf_sf"]) < CONF_MARGIN * top
    return close | (ref["conf_sf"] > ref["conf_mf"]), close | (ref["conf_mf"] >= ref["conf_sf"])


def distances(rows: np.ndarray, ref: dict) -> tuple[np.ndarray, np.ndarray]:
    """Per keypoint of ``rows (C, V, N, 3K)``: the distance in frame pixels
    to the nearest eligible head's answer, and the likelihood's difference
    from the higher confidence relative to it, each ``(C, V, N, K)`` (inf
    where not finite)."""
    xy = np.stack([rows[..., 0::3], rows[..., 1::3]], axis=-1)
    sf, mf = eligible(ref)
    dist = np.full(xy.shape[:-1], np.inf)
    for head, ok in (("sf", sf), ("mf", mf)):
        d = np.linalg.norm(xy - ref[f"xy_{head}"][None], axis=-1)
        dist = np.minimum(dist, np.where(ok[None] & np.isfinite(d), d, np.inf))
    top = np.maximum(ref["conf_sf"], ref["conf_mf"])[None]
    dlik = np.abs(rows[..., 2::3] - top) / top
    return dist, np.where(np.isfinite(dlik), dlik, np.inf)


def motion(ref: dict) -> np.ndarray:
    """``(V, K)``: each keypoint's median distance, in frame pixels, between
    the reference's answers (the more confident head's) on neighbouring
    frames."""
    xy = np.where((ref["conf_mf"] >= ref["conf_sf"])[..., None], ref["xy_mf"], ref["xy_sf"])
    return np.median(np.linalg.norm(np.diff(xy, axis=1), axis=-1), axis=1)


def video_numbers(rows: np.ndarray, ref: dict, yardstick: np.ndarray) -> tuple[dict[str, float], int]:
    """``rows (C, V, N, 3K)``: each call's rows per view (x, y, likelihood a
    keypoint), against ``ref`` (each head's ``xy_<h> (V, N, K, 2)`` and
    ``conf_<h> (V, N, K)``), in units of ``yardstick (1, V, N, 3K)``'s
    distances from it. Returns the compared numbers and the count of calls
    whose rows are misshapen or not finite."""
    c, v, n, width = rows.shape
    if ref["xy_sf"].shape != (v, n, width // 3, 2):
        return dict.fromkeys(NAMES, float("inf")), c
    bad = int((~np.isfinite(rows).reshape(c, -1).all(axis=1)).sum())
    dist, dlik = (a.reshape(c, v, -1) for a in distances(rows, ref))
    unit, unit_lik = (a.reshape(1, v, -1) for a in distances(yardstick, ref))

    def ratio(values: np.ndarray, units: np.ndarray, q: float) -> float:
        return float((np.quantile(values, q, axis=-1) / np.maximum(np.quantile(units, q, axis=-1), TINY)).max())

    return {"kp_median_ratio": ratio(dist, unit, 0.5), "kp_q99_ratio": ratio(dist, unit, 0.99),
            "lik_median_ratio": ratio(dlik, unit_lik, 0.5)}, bad


def motion_ratio(rows: np.ndarray, ref: dict) -> float:
    """The median distance of ``rows (C, V, N, 3K)`` from ``ref`` over each
    keypoint's :func:`motion`, per call and view; the largest."""
    c, v = rows.shape[:2]
    scaled = distances(rows, ref)[0] / np.maximum(motion(ref), TINY)[None, :, None, :]
    return float(np.median(scaled.reshape(c, v, -1), axis=-1).max())


def judge(numbers: dict[str, float], limits: dict) -> tuple[bool, dict]:
    """Each number beside its limit (``limits[name]["limit"]``); correct
    when every number is at most its limit. A number without a limit fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name, {}).get("limit")
        checks[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, checks
