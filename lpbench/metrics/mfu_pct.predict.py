"""The model FLOPs that the window's outputs need (the trunk once a
distinct frame of each view, the heads once a window; counted on the
reference by ``FlopCounterMode``) over the wall time of the untraced calls,
as a share of one H100's 989 TFLOP/s in bf16 (dense)."""

from lpbench.counts.kernels import BF16_FLOPS_PER_S


def read(run):
    c = run.counts
    if not c.get("untraced_calls") or c["untraced_s"] <= 0:
        return None
    return 100.0 * c["untraced_calls"] * c["flops_per_call"] / c["untraced_s"] / BF16_FLOPS_PER_S
