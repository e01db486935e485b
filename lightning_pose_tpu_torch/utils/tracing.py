"""Named host spans on the profiler's clock, and their running totals.

``span(name)`` opens a ``torch.profiler.record_function`` range, so that any
``torch.profiler`` trace taken around the code shows the span as a
``user_annotation`` on the same clock as the device's kernels, copies and
fills: a stretch in which the device sat idle can be put down to the host
span that was open. Each span also adds its seconds and a count of one to a
process-wide table, which :func:`totals` reads, so that a caller can log
where its time went with no profiler running.

With no profiler running a span costs a few microseconds, so the spans are
always on. A span opens and closes within one resumption of a generator,
never across a ``yield``: a range left open while the consumer runs would
cover the consumer's work too. Worker threads' spans reach a trace only
where the profiler records every thread
(``torch.profiler._ExperimentalConfig(profile_all_threads=True)``).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

from torch.profiler import record_function

__all__ = ["span", "totals"]

_lock = threading.Lock()
# name -> [seconds, count], over the life of the process
_totals: dict[str, list] = {}


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Time the body as the host span ``name`` (a profiler range, and the
    totals of :func:`totals`)."""
    start = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        seconds = time.perf_counter() - start
        with _lock:
            entry = _totals.setdefault(name, [0.0, 0])
            entry[0] += seconds
            entry[1] += 1


def totals() -> dict[str, tuple[float, int]]:
    """A snapshot of every span's ``(seconds, count)`` so far, by name, over
    every thread of the process."""
    with _lock:
        return {name: (seconds, count) for name, (seconds, count) in _totals.items()}
