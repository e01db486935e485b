"""The readers of the program's host spans (``lpbench/spans.py`` and the
``program_span`` metrics) on a small synthetic trace."""

from __future__ import annotations

import pytest

from lpbench import harness, spans, trace
from lpbench.harness import Run

SPAN_METRICS = ("open_s.predict", "loader_wait_ms.predict", "stage_ms.predict", "launch_ms.predict",
                "csv_s.predict")


def _x(name, ts, dur, tid=1):
    return {"name": name, "cat": "user_annotation", "ph": "X", "ts": ts, "dur": dur, "tid": tid, "pid": 1,
            "args": {}}


@pytest.fixture
def span_run():
    """A 10 ms window on the loop thread (tid 1): one call of three batches.
    A worker thread's step span and a write span after the window are not
    the call's."""
    events = [
        _x(trace.WINDOW, 0, 10000),
        _x("lp.predict.open", 10, 490),
        _x("lp.loader.next", 500, 300),  # the pipeline's fill
        _x("lp.copy.stage", 800, 8),
        _x("lp.predict.step", 810, 10),
        _x("lp.loader.next", 1000, 20),
        _x("lp.copy.stage", 1020, 6),
        _x("lp.predict.step", 1030, 15),
        _x("lp.loader.next", 2000, 30),
        _x("lp.copy.stage", 2030, 4),
        _x("lp.predict.step", 2040, 10),
        _x("lp.loader.next", 3000, 10),  # the loop's end
        _x("lp.predict.fetch", 3010, 490),
        _x("lp.predict.write", 3700, 100),
        _x("lp.predict.write", 3500, 200),
        _x("lp.predict.metrics", 3800, 400),
        _x("lp.predict.step", 900, 5000, tid=5),
        _x("lp.loader.decode", 100, 500, tid=5),
        _x("lp.predict.write", 20000, 900),
    ]
    return Run(metrics={}, counts={"batches_per_call": 3}, attempted=1, trace=trace.Trace(events))


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_loop_spans_are_the_window_threads_in_order(span_run):
    writes = spans.loop_spans(span_run.trace, "lp.predict.write")
    assert [e["ts"] for e in writes] == [3500, 3700]
    assert [e["ts"] for e in spans.loop_spans(span_run.trace, "lp.predict.step")] == [810, 1030, 2040]
    assert spans.loop_spans(span_run.trace, "lp.loader.decode") == []
    assert spans.seconds(writes) == pytest.approx(300e-6)


@pytest.mark.parametrize("name, value", [
    ("open_s.predict", (490 + 300) * 1e-6),
    ("loader_wait_ms.predict", (20 + 30 + 10) * 1e-3 / 2),
    ("stage_ms.predict", (8 + 6 + 4) * 1e-3 / 3),
    ("launch_ms.predict", (10 + 15 + 10) * 1e-3 / 3),
    ("csv_s.predict", (200 + 100 + 400) * 1e-6),
])
def test_span_readers(span_run, name, value):
    assert _read(name, span_run) == pytest.approx(value)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_readers_return_nothing_without_their_spans(span_run, name):
    bare = Run(metrics={}, counts=span_run.counts, attempted=1, trace=trace.Trace([_x(trace.WINDOW, 0, 10000)]))
    assert _read(name, bare) is None
    untraced = Run(metrics={}, counts=span_run.counts, attempted=1, trace=None)
    assert _read(name, untraced) is None
    # a worker thread's spans are not the loop's
    workers = [dict(e, tid=5) if e["name"] != trace.WINDOW else e for e in span_run.trace.events]
    assert _read(name, Run(metrics={}, counts=span_run.counts, attempted=1, trace=trace.Trace(workers))) is None
