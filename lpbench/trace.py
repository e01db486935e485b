"""``torch.profiler`` capture of one steady stretch of a run, and the
reductions that the per-layer readers share.

The capture records host and CUDA activity between two marks and exports
the Chrome trace, which is read back as a list of events and deleted. A
kernel is tied to the host range that launched it through the correlation
id that its launch call (``cuda_runtime`` or ``cuda_driver``) shares with
it; host ranges are opened from the benchmark's own files
(``torch.profiler.record_function``), never inside the program.
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["Trace", "capture", "range_hooks"]

WINDOW = "lpbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclass
class Trace:
    """The events of one capture (Chrome trace format: ``ts`` and ``dur`` in
    microseconds)."""

    events: list[dict] = field(default_factory=list)

    def window(self) -> tuple[float, float]:
        """Start and end (us) of the :data:`WINDOW` range."""
        for e in self.events:
            if e.get("name") == WINDOW and e.get("cat") == "user_annotation":
                return float(e["ts"]), float(e["ts"]) + float(e["dur"])
        raise ValueError("the trace has no window mark")

    def device_events(self) -> list[dict]:
        """Kernels, copies and fills inside the window."""
        lo, hi = self.window()
        return [e for e in self.events if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"
                and lo <= float(e["ts"]) < hi]

    def kernels(self, name_part: str = "") -> list[dict]:
        """The window's kernels whose name holds ``name_part``."""
        return [e for e in self.device_events() if e.get("cat") == "kernel" and name_part in e["name"]]

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the window's device intervals, sorted (us)."""
        lo, hi = self.window()
        spans = sorted((max(float(e["ts"]), lo), min(float(e["ts"]) + float(e["dur"]), hi))
                       for e in self.device_events())
        merged: list[list[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            elif b > a:
                merged.append([a, b])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def window_s(self) -> float:
        lo, hi = self.window()
        return (hi - lo) * 1e-6

    def launched_within(self, range_names: tuple[str, ...]) -> list[dict]:
        """The window's kernels whose launch call lies inside a host range
        of one of ``range_names`` on the same thread."""
        ranges = [(e["tid"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in self.events
                  if e.get("cat") == "user_annotation" and e.get("name") in range_names]
        inside = set()
        for e in self.events:
            if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
                t = float(e["ts"])
                if any(tid == e["tid"] and a <= t <= b for tid, a, b in ranges):
                    inside.add(e["args"]["correlation"])
        return [k for k in self.kernels() if k.get("args", {}).get("correlation") in inside]

    def top_device_ops(self, n: int = 10) -> list[list]:
        """The ``n`` device operations that took most time, by name (s)."""
        totals: dict[str, float] = {}
        for e in self.device_events():
            totals[e["name"]] = totals.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
        return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest stretches of the window with nothing on the
        device (s), each named by the host range of the window's thread
        that overlaps it most (or ``host: none`` where no range does)."""
        lo, hi = self.window()
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                      key=lambda g: g[0] - g[1])[:n]
        main = next(e["tid"] for e in self.events if e.get("name") == WINDOW)
        host = [e for e in self.events if e.get("cat") in HOST_CATS and e.get("tid") == main
                and e.get("name") != WINDOW and e.get("ph") == "X"]
        out = []
        for a, b in gaps:
            best, overlap = "none", 0.0
            for e in host:
                o = min(b, float(e["ts"]) + float(e["dur"])) - max(a, float(e["ts"]))
                if o > overlap:
                    best, overlap = e["name"], o
            out.append([f"host: {best}", (b - a) * 1e-6])
        return out


@contextlib.contextmanager
def capture(directory: Path):
    """Profile the body (host and CUDA activity) inside a :data:`WINDOW`
    range; yields a :class:`Trace` that holds the events once the body has
    run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    trace = Trace()
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / "trace.json"
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield trace
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    try:
        trace.events = json.loads(path.read_text())["traceEvents"]
    finally:
        path.unlink(missing_ok=True)


def range_hooks(modules: dict[str, object]) -> list:
    """A host range named ``name`` around each forward of each module of
    ``{name: module}``; returns the hook handles (``.remove()`` them)."""
    from torch.profiler import record_function

    handles = []
    for name, module in modules.items():
        open_ranges: list = []

        def pre(_m, _args, name=name, open_ranges=open_ranges):
            r = record_function(name)
            r.__enter__()
            open_ranges.append(r)

        def post(_m, _args, _out, open_ranges=open_ranges):
            open_ranges.pop().__exit__(None, None, None)

        handles.append(module.register_forward_pre_hook(pre))
        handles.append(module.register_forward_hook(post))
    return handles
