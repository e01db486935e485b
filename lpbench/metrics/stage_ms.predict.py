"""Milliseconds a batch of host time staging the host-to-device copy in the
traced call: the span ``lp.copy.stage`` (the wait for the pinned buffer's
previous copy, the copy into pinned memory, the side-stream copy enqueued),
summed, over the call's batches."""

from lpbench.spans import loop_spans, seconds


def read(run):
    if run.trace is None:
        return None
    stages = loop_spans(run.trace, "lp.copy.stage")
    if not stages:
        return None
    return seconds(stages) * 1e3 / run.counts["batches_per_call"]
