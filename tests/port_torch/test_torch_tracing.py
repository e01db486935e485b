"""The host spans of the port's video-predict path (``utils/tracing.py``):
where they sit in a ``torch.profiler`` trace, and their totals with no
profiler running.

Both predict functions run on two short written videos with a stub step
that returns zero keypoints, so what is checked is the loop around the
model: the loader, the copy staging, the launches, the fetch and the CSVs.
The loader runs its serial path (one decode thread a view) and its
window-sharded one (two).
"""

from __future__ import annotations

import json
import logging

import pytest
import torch
from conftest import _write_video
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile, record_function

VIEWS = ("top", "bot")
KEYPOINTS = 3
FRAMES = 22
SEQ_LEN = 8
# the loop thread's spans, in the order a call first opens them
LOOP = ("lp.predict.open", "lp.loader.next", "lp.copy.stage", "lp.predict.step", "lp.predict.fetch",
        "lp.predict.write", "lp.predict.metrics")
CALL = "test.call"
# microseconds: the trace's timestamps and durations are rounded apart
ROUNDING_US = 0.002


@pytest.fixture(scope="module")
def two_videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("tracing_videos")
    return [str(_write_video(root / f"session_{view}.mp4", FRAMES, 48, 64, seed=i)) for i, view in enumerate(VIEWS)]


def _predict(videos: list[str], multiview: bool, model_dir, labeled: bool = False) -> int:
    """One call of ``predict_video_multiview`` on both videos, or of
    ``predict_video`` on the first, with a stub step (and labeled videos
    with ``labeled``); returns the loader's batch count."""
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.data.video import PredictVideoLoader
    from lightning_pose_tpu_torch.utils.video_predictions import predict_video, predict_video_multiview

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = [f"kp{i}" for i in range(KEYPOINTS)]
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 32
    cfg.model.model_type = "heatmap"
    cfg.model.losses_to_use = []
    cfg.dali.base.predict.sequence_length = SEQ_LEN
    k = KEYPOINTS * (len(VIEWS) if multiview else 1)

    def zero_keypoints(images, bbox):
        return torch.zeros(images.shape[0], 2 * k), torch.zeros(images.shape[0], k)

    cpu = torch.device("cpu")
    if multiview:
        cfg.data.view_names = list(VIEWS)
        predict_video_multiview(videos, list(VIEWS), cfg, zero_keypoints, str(model_dir), cpu,
                                generate_labeled_video=labeled)
    else:
        predict_video(videos[0], cfg, zero_keypoints, str(model_dir), cpu, generate_labeled_video=labeled)
    return len(PredictVideoLoader(videos[0], SEQ_LEN, 32, 32))


def _expected_counts(batches: int, multiview: bool, labeled: bool = False) -> dict[str, int]:
    views = len(VIEWS) if multiview else 1
    return {
        "lp.predict.open": 1,
        "lp.loader.next": batches + 1,  # the last one ends the loop
        "lp.copy.stage": batches,
        "lp.predict.step": batches,
        "lp.predict.fetch": 1,
        # the multiview handler, then one CSV a view
        "lp.predict.write": 1 + views if multiview else 1,
        "lp.predict.metrics": views,
        "lp.loader.decode": batches * views,
        **({"lp.predict.labeled_video": views} if labeled else {}),
    }


@pytest.mark.parametrize("threads", [1, 2], ids=["serial", "sharded"])
@pytest.mark.parametrize("multiview", [False, True], ids=["single", "multiview"])
def test_spans_land_in_a_profiler_trace(two_videos, tmp_path, monkeypatch, multiview, threads):
    monkeypatch.setenv("LP_TPU_DECODE_THREADS", str(threads))
    config = _ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        with record_function(CALL):
            batches = _predict(two_videos, multiview, tmp_path / "model")
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    loop_tid = next(e["tid"] for e in events if e["name"] == CALL)
    loop = sorted((e for e in events if e["tid"] == loop_tid and e["name"].startswith("lp.")),
                  key=lambda e: float(e["ts"]))
    workers = [e for e in events if e["tid"] != loop_tid and e["name"].startswith("lp.")]
    expected = _expected_counts(batches, multiview)

    assert {e["name"] for e in loop} == set(LOOP)
    assert {name: sum(e["name"] == name for e in loop) for name in LOOP} == {name: expected[name] for name in LOOP}
    assert {e["name"] for e in workers} == {"lp.loader.decode"}
    assert len(workers) == expected["lp.loader.decode"]
    # no loop span nests or overlaps another, so that each idle moment of
    # the device falls under at most one of them
    for a, b in zip(loop, loop[1:]):
        assert float(a["ts"]) + float(a["dur"]) <= float(b["ts"]) + ROUNDING_US, (a["name"], b["name"])
    order = [e["name"] for e in loop]
    assert order[:2] == ["lp.predict.open", "lp.loader.next"]
    last_next = len(order) - 1 - order[::-1].index("lp.loader.next")
    assert set(order[last_next + 1:]) == {"lp.predict.fetch", "lp.predict.write", "lp.predict.metrics"}
    assert order[last_next + 1] == "lp.predict.fetch"


@pytest.mark.parametrize("multiview", [False, True], ids=["single", "multiview"])
def test_totals_count_the_spans_without_a_profiler(two_videos, tmp_path, caplog, multiview):
    from lightning_pose_tpu_torch.utils import tracing

    before = tracing.totals()
    with caplog.at_level(logging.INFO, logger="lightning_pose_tpu_torch.utils.video_predictions"):
        batches = _predict(two_videos, multiview, tmp_path / "model", labeled=True)
    after = tracing.totals()
    spent = {name: (seconds - before.get(name, (0.0, 0))[0], count - before.get(name, (0.0, 0))[1])
             for name, (seconds, count) in after.items() if name.startswith("lp.")}

    expected = _expected_counts(batches, multiview, labeled=True)
    assert {name: count for name, (_, count) in spent.items() if count} == expected
    assert all(seconds > 0 for seconds, count in spent.values() if count)
    line = next(r.getMessage() for r in caplog.records if "frames/s" in r.getMessage())
    for name in expected:
        assert name in line
