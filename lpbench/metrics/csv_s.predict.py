"""Seconds the traced call spent on its CSVs: the spans
``lp.predict.write`` (the predictions' dataframes built and written) and
``lp.predict.metrics`` (each view's CSV read back and its metric CSVs
written)."""

from lpbench.spans import loop_spans, seconds


def read(run):
    if run.trace is None:
        return None
    writes = loop_spans(run.trace, "lp.predict.write")
    if not writes:
        return None
    return seconds(writes) + seconds(loop_spans(run.trace, "lp.predict.metrics"))
