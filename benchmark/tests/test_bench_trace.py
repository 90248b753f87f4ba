"""The profiled stretch's reduction (harness/trace.py) on a trace whose
answers are known."""

from types import SimpleNamespace

import pytest

from harness import readers, trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", "bench.stretch", 0, 1000),
    _x("user_annotation", "bench.epoch", 0, 900),
    _x("user_annotation", "bench.d_step", 10, 400),
    _x("user_annotation", "bench.k2", 20, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 2, corr=1),
    _x("cuda_runtime", "cudaLaunchKernel", 60, 2, corr=2),
    _x("user_annotation", "bench.log_flush", 920, 60),
    _x("kernel", "ghost_norm_tc", 100, 200, tid=7, corr=1),
    _x("kernel", "sm90_xmma_fprop_implicit_gemm", 250, 150, tid=7, corr=2),
    _x("gpu_memcpy", "Memcpy HtoD", 2000, 10, tid=7),
]


def test_busy_kernel_time_and_gaps():
    r = trace.reduce(EVENTS, ["k2", "k3"])
    assert r["span_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx(300e-6)          # [100, 400), the copy is outside
    assert r["kernel_s"] == {"k2": pytest.approx(200e-6), "k3": 0.0}
    assert r["kernel_n"] == {"k2": 1, "k3": 0}
    ops = dict(r["device_ops"])
    assert ops["K2"] == pytest.approx(200e-6) and ops["cuDNN convolutions"] == pytest.approx(150e-6)
    gaps = dict(r["idle_gaps"])
    assert gaps["D step"] == pytest.approx(100e-6)        # [0, 100) inside the D step
    # [400, 1000): its middle, 700, is in the runner call, outside any step.
    assert gaps["runner outside the steps"] == pytest.approx(600e-6)
    assert sum(gaps.values()) == pytest.approx(700e-6)


def test_no_stretch_reads_nothing():
    assert trace.reduce(EVENTS[1:], ["k2"]) == {}


def _run(launched):
    counts = SimpleNamespace(KERNELS={"k2": lambda call: (1e9, 0.0, "bf16")})
    return SimpleNamespace(kernel_calls={"k2": [{}]}, counts=counts, launched=launched,
                           peaks={"bf16": 1e12, "bytes": 1e12},
                           trace={"kernel_s": {"k2": 2e-3}, "kernel_n": {"k2": 1}})


def test_a_trace_that_dropped_launches_reads_no_roofline():
    """Where the program counts its own launches of a kernel, a trace that
    holds another number of them gives no share; otherwise the share is the
    least time over the device time."""
    assert readers.roofline_pct(_run({"k2": 3}), "k2") is None
    assert readers.roofline_pct(_run({"k2": 1}), "k2") == pytest.approx(50.0)
    assert readers.roofline_pct(_run({}), "k2") == pytest.approx(50.0)
