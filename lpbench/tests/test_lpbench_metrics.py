"""Each per-layer reader's arithmetic on a small synthetic trace."""

from __future__ import annotations

import pytest

from lpbench import harness, trace
from lpbench.counts import kernels
from lpbench.harness import Run


def _x(name, cat, ts, dur, tid=1, **args):
    return {"name": name, "cat": cat, "ph": "X", "ts": ts, "dur": dur, "tid": tid, "pid": 1, "args": args}


@pytest.fixture
def synthetic_run():
    """A 1000 us window: the trunk range launches two kernels (corr 1, 2),
    the decode two (3, 4, one overlapping the other), normalize one (5); a
    copy; a kernel outside the window."""
    events = [
        _x(trace.WINDOW, "user_annotation", 0, 1000),
        _x("lpbench.trunk", "user_annotation", 100, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 110, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 150, 5, correlation=2),
        _x("cudaLaunchKernelExC", "cuda_runtime", 300, 5, correlation=3),
        _x("cudaLaunchKernelExC", "cuda_runtime", 310, 5, correlation=4),
        _x("cuLaunchKernel", "cuda_driver", 20, 5, correlation=5),
        _x("aten::copy_", "cpu_op", 600, 300),
        _x("sm90_conv_fprop", "kernel", 200, 100, tid=7, correlation=1),
        _x("sm90_conv_fprop", "kernel", 300, 50, tid=7, correlation=2),
        _x("void decode_kernel<2>(float const*)", "kernel", 400, 40, tid=7, correlation=3),
        _x("void decode_kernel<2>(float const*)", "kernel", 420, 40, tid=7, correlation=4),
        _x("normalize_kernel", "kernel", 30, 20, tid=7, correlation=5),
        _x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 500, 50, tid=8),
        _x("decode_grad_kernel", "kernel", 2000, 10, tid=7, correlation=9),
    ]
    counts = {"untraced_calls": 3, "untraced_s": 1.5, "flops_per_call": 2.0e12, "batches_per_call": 2,
              "normalize_pixels_per_launch": 1000, "decode_maps_per_launch": 14, "map_hw": (64, 64)}
    return Run(metrics={}, counts=counts, attempted=4, trace=trace.Trace(events))


def test_trace_reductions(synthetic_run):
    t = synthetic_run.trace
    # busy: [30, 50], [200, 350], [400, 460], [500, 550] -> 280 us
    assert t.busy_s() == pytest.approx(280e-6)
    assert t.window_s() == pytest.approx(1e-3)
    assert [k["args"]["correlation"] for k in t.launched_within(("lpbench.trunk",))] == [1, 2]
    assert len(t.kernels("decode_kernel")) == 2  # the backward is outside the window
    top = t.top_device_ops()
    assert top[0] == ["sm90_conv_fprop", pytest.approx(150e-6)]
    gaps = t.idle_gaps(2)
    assert gaps[0] == ["host: aten::copy_", pytest.approx(450e-6)]
    assert gaps[1] == ["host: lpbench.trunk", pytest.approx(150e-6)]


def _read(name, run):
    return harness.load_module("metrics", name).read(run)


def test_readers(synthetic_run):
    assert _read("device_idle_pct.predict", synthetic_run) == pytest.approx(72.0)
    assert _read("trunk_device_ms.predict", synthetic_run) == pytest.approx(0.150 / 2)
    assert _read("mfu_pct.predict", synthetic_run) == pytest.approx(100 * 3 * 2e12 / 1.5 / 989e12)
    norm = kernels.normalize_bytes(1000) / kernels.HBM_BYTES_PER_S
    assert _read("normalize_roofline.predict", synthetic_run) == pytest.approx(100 * norm / 20e-6)
    dec = kernels.bound_s(kernels.decode_bytes(14, 64, 64), kernels.decode_flops(14, 64, 64))
    assert _read("decode_roofline.predict", synthetic_run) == pytest.approx(100 * 2 * dec / 80e-6)


def test_readers_return_nothing_without_their_events(synthetic_run):
    empty = Run(metrics={}, counts=dict(synthetic_run.counts, untraced_calls=0), attempted=1,
                trace=trace.Trace([_x(trace.WINDOW, "user_annotation", 0, 1000)]))
    for name in ("device_idle_pct.predict", "trunk_device_ms.predict", "normalize_roofline.predict",
                 "decode_roofline.predict", "mfu_pct.predict"):
        assert _read(name, empty) is None
