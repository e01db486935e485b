"""Milliseconds a batch of host time in the predict step in the traced
call: the span ``lp.predict.step`` around each call of the step (its
launches, and any wait on the card inside it), summed, over the call's
batches. The profiler lengthens the host time of each ATen op it records,
so this reads above an untraced call's."""

from lpbench.spans import loop_spans, seconds


def read(run):
    if run.trace is None:
        return None
    steps = loop_spans(run.trace, "lp.predict.step")
    if not steps:
        return None
    return seconds(steps) * 1e3 / run.counts["batches_per_call"]
