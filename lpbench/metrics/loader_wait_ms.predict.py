"""Milliseconds a batch that the predict loop waited on the decode workers
(and stacked the views) after its first batch, in the traced call: every
``lp.loader.next`` span but the first, the last one's end of the loop
included, over the batches after the first."""

from lpbench.spans import loop_spans, seconds


def read(run):
    if run.trace is None:
        return None
    waits = loop_spans(run.trace, "lp.loader.next")
    later = run.counts["batches_per_call"] - 1
    if len(waits) < 2 or later < 1:
        return None
    return seconds(waits[1:]) * 1e3 / later
