"""The decode kernel's share of its roofline in the traced call: the
larger of its bytes at 3.35 TB/s and its FP32 operations at 67 TFLOP/s
(``lpbench/counts/kernels.py``) over its device time, summed over its
launches (two a batch: one a head)."""

from lpbench.counts.kernels import bound_s, decode_bytes, decode_flops


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernels("decode_kernel")
    if not launches:
        return None
    maps = run.counts["decode_maps_per_launch"]
    h, w = run.counts["map_hw"]
    bound = bound_s(decode_bytes(maps, h, w), decode_flops(maps, h, w))
    return 100.0 * bound * len(launches) / (sum(float(k["dur"]) for k in launches) * 1e-6)
