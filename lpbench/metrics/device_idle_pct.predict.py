"""Share of the traced call's wall time in which nothing ran on the device
(no kernel, copy or fill), from the profiler's trace."""


def read(run):
    if run.trace is None or not run.trace.device_events():
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s())
