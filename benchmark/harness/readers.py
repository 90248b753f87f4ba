"""What the per-layer metric files share: a kernel's share of its roofline
and the model's share of the card's peak, from a run's numbers (the
namespace ``driver.run`` hands each reader)."""

from __future__ import annotations

from typing import Optional

from .peaks import bound_s


def roofline_pct(run, tag: str) -> Optional[float]:
    """100 x the least time of the kernel's calls in the profiled stretch
    (each call's operations and bytes from its shapes, the config's counts
    file, against the card's peaks) over the device time of the kernels
    launched inside them; None when the stretch holds no call or no device
    time of it, or when the program counts its own launches of the kernel
    (``launch_counters``) and the trace holds another number of them: a
    trace that dropped records would overstate the share."""
    calls = run.kernel_calls.get(tag) or []
    trace = run.trace or {}
    dev_s = trace.get("kernel_s", {}).get(tag, 0.0)
    fn = getattr(run.counts, "KERNELS", {}).get(tag)
    if not calls or dev_s <= 0 or run.peaks is None or fn is None:
        return None
    launched = getattr(run, "launched", {}).get(tag)
    if launched is not None and trace.get("kernel_n", {}).get(tag) != launched:
        return None
    least = 0.0
    for call in calls:
        ops, nbytes, peak = fn(call)
        least += bound_s(ops, nbytes, run.peaks.get(peak, 0.0), run.peaks["bytes"])
    return 100.0 * least / dev_s


def mfu_pct(run) -> Optional[float]:
    """100 x the model's FLOPs over the window (the profiled stretch left
    out) against the peak of the configuration's precision."""
    if run.peaks is None or run.window_s <= 0 or run.d_steps <= 0:
        return None
    flops = run.counts.model_flops(run.d_steps, run.g_steps, run.batch)
    return 100.0 * flops / run.window_s / run.peaks[run.counts.PRECISION_PEAK]
