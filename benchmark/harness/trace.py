"""The profiled stretch of a ``--trace 1`` run and what it reads.

``Stretch`` opens ``torch.profiler`` (CPU and CUDA activity) around one
runner call and its epoch boundary: a first tiny kernel takes the record
that a profiler opened late in a process has been seen to lose, then the
range ``bench.stretch`` spans the stretch. ``read`` exports the trace as
chrome JSON and reduces it:

- busy: the union of the device's kernel, copy and set intervals inside the
  stretch's span; idle = span - busy;
- each kernel tag's device time: the device operations whose launch (the
  CUDA runtime or driver call of the same correlation id) lies inside a
  ``bench.<tag>`` range on the same thread; and the number of those that
  are kernels, which the harness holds against the program's own count of
  launches where it has one (a trace can drop records);
- ``device_ops``: device seconds by group (the kernel tags, then the
  library groups by kernel name), the ten largest;
- ``idle_gaps``: idle seconds by what the host was doing at each gap's
  middle (the harness's spans: D step, G step, log flush, sample grid,
  accounting, the runner outside steps, the epoch boundary), largest first.
"""

from __future__ import annotations

import bisect
import json
import os
from pathlib import Path
from typing import Dict, List

import torch

# Library kernels by group; the first match of a name part wins.
GROUPS = (
    ("cuDNN convolutions", ("implicit_gemm", "cudnn", "fprop", "dgrad", "wgrad", "conv")),
    ("cuBLAS GEMMs", ("gemm", "gemv")),
    ("im2col", ("im2col",)),
    ("copies and casts", ("copy", "Memcpy", "Memset")),
    ("reductions", ("reduce_kernel",)),
    ("other element-wise", ("elementwise",)),
)
SPANS = {"bench.d_step": "D step", "bench.g_step": "G step", "bench.log_flush": "log flush",
         "bench.grid": "sample grid", "bench.accounting": "accounting",
         "bench.epoch": "runner outside the steps"}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Stretch:
    """A context that profiles the device over its body."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.ones(1, device=self.device).add_(1)
        torch.cuda.synchronize()
        self._range = torch.profiler.record_function("bench.stretch")
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        return False


def _union(intervals: List[tuple], lo: float, hi: float) -> List[tuple]:
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals if b > lo and a < hi):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class _Spans:
    """Ranges of one name set on each thread, for innermost-containing
    lookups."""

    def __init__(self, ranges: List[tuple]):
        self.by_tid: Dict = {}
        for tid, a, b, name in ranges:
            self.by_tid.setdefault(tid, []).append((a, b, name))
        self.starts = {}
        for tid, rs in self.by_tid.items():
            rs.sort()
            self.starts[tid] = [r[0] for r in rs]

    def at(self, tid, t: float):
        rs = self.by_tid.get(tid)
        if not rs:
            return None
        i = bisect.bisect_right(self.starts[tid], t) - 1
        for j in range(i, max(i - 16, -1), -1):
            a, b, name = rs[j]
            if a <= t <= b:
                return name
        return None

    def at_any(self, t: float):
        for tid in self.by_tid:
            name = self.at(tid, t)
            if name is not None:
                return name
        return None


def _group(name: str) -> str:
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return "other"


def read(stretch: Stretch, tmp_dir: Path, tags: List[str]) -> dict:
    """The stretch's numbers (seconds): span, busy, device time and kernel
    count by kernel tag, device_ops and idle_gaps."""
    path = Path(tmp_dir) / f"stretch-{os.getpid()}.json"
    stretch.prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        path.unlink(missing_ok=True)
    return reduce(events, tags)


def reduce(events: List[dict], tags: List[str]) -> dict:
    """``read``'s numbers from a chrome trace's events (times in us):
    seconds, and ``kernel_n``, the kernels launched inside each tag."""
    span = [e for e in events if e.get("name") == "bench.stretch"
            and e.get("cat") == "user_annotation"]
    if not span:
        return {}
    s0, s1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] + e.get("dur", 0) > s0 and e["ts"] < s1]
    launches = {e["args"]["correlation"]: (e.get("tid"), e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    annots = [(e.get("tid"), e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e.get("name", "").startswith("bench.")]
    kernel_spans = _Spans([a for a in annots if a[3][len("bench."):] in tags])
    host_spans = _Spans([a for a in annots if a[3] in SPANS and a[3] != "bench.epoch"])
    runner_spans = _Spans([a for a in annots if a[3] == "bench.epoch"])
    busy_iv = _union([(e["ts"], e["ts"] + e.get("dur", 0)) for e in dev], s0, s1)
    busy = sum(b - a for a, b in busy_iv)
    by_tag = {t: 0.0 for t in tags}
    n_tag = {t: 0 for t in tags}
    groups: Dict[str, float] = {}
    for e in dev:
        tag = None
        corr = e.get("args", {}).get("correlation")
        if corr in launches:
            tid, t = launches[corr]
            name = kernel_spans.at(tid, t)
            tag = None if name is None else name[len("bench."):]
        dur = e.get("dur", 0)
        if tag is not None:
            by_tag[tag] += dur
            n_tag[tag] += e.get("cat") == "kernel"
            key = tag.upper()
        else:
            key = _group(e.get("name", ""))
        groups[key] = groups.get(key, 0.0) + dur
    gaps: Dict[str, float] = {}
    prev = s0
    for a, b in busy_iv + [(s1, s1)]:
        if a > prev:
            mid = 0.5 * (a + prev)
            name = host_spans.at_any(mid) or ("bench.epoch" if runner_spans.at_any(mid)
                                              else None)
            label = SPANS.get(name, "epoch boundary (host)")
            gaps[label] = gaps.get(label, 0.0) + (a - prev)
        prev = max(prev, b)
    def top(d):
        return [[k, v * 1e-6] for k, v in sorted(d.items(), key=lambda kv: -kv[1])][:10]
    return {"span_s": (s1 - s0) * 1e-6, "busy_s": busy * 1e-6,
            "kernel_s": {t: v * 1e-6 for t, v in by_tag.items()}, "kernel_n": n_tag,
            "device_ops": top(groups), "idle_gaps": top(gaps), "device_op_count": len(dev)}
