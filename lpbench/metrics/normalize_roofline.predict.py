"""The normalize kernel's share of its roofline in the traced call: the
least time its bytes need at 3.35 TB/s (uint8 RGB read once, bf16 written
once) over its device time, summed over its launches."""

from lpbench.counts.kernels import bound_s, normalize_bytes


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels("normalize_kernel")
    if not launches:
        return None
    bound = bound_s(normalize_bytes(run.counts["normalize_pixels_per_launch"]), 0)
    return 100.0 * bound * len(launches) / (sum(float(k["dur"]) for k in launches) * 1e-6)
