"""Seconds from the predict call's entry to its first batch in the traced
call: the span ``lp.predict.open`` (the loaders built, frames counted, frame
sizes, the bbox tensor) plus the first ``lp.loader.next`` (the decoders
started and the first batch decoded: the pipeline's fill)."""

from lpbench.spans import loop_spans, seconds


def read(run):
    if run.trace is None:
        return None
    opened, waits = loop_spans(run.trace, "lp.predict.open"), loop_spans(run.trace, "lp.loader.next")
    if not opened or not waits:
        return None
    return seconds(opened) + seconds(waits[:1])
