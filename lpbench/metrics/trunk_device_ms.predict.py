"""Device time a batch of the kernels launched inside the trunk's and the
heads' forward (host ranges opened by forward hooks from the benchmark's
driver), in the traced call."""

from lpbench.drivers.predict_video import HEADS_RANGE, TRUNK_RANGE


def read(run):
    if run.trace is None:
        return None
    kernels = run.trace.launched_within((TRUNK_RANGE, HEADS_RANGE))
    if not kernels:
        return None
    return sum(float(k["dur"]) for k in kernels) * 1e-3 / run.counts["batches_per_call"]
