"""Training profile under ``-p`` / ``--profile_training``.

The reference wraps training in ``torch.profiler`` and, when the trace is
ready, prints its key-averages table and writes the chrome trace (reference
train.py:139-148, quoted in the JAX package's training/profiling.py). The
port does the same over the Trainer's ``run()`` (``TrainingProfile``: the
trace as chrome JSON under ``<output_dir>/profile/``), and, as the JAX
package does, brackets the Trainer's phases with wall-clock sections
(``SectionTimer``, the port's copy of the JAX package's) whose summary it
prints at the end. Under ``-p`` each timed section ends with
``torch.cuda.synchronize`` on the card, so a section's time is its device
work, not its launches; that costs the overlap between host and device, so
it happens only under the flag.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

import torch


class SectionTimer:
    def __init__(self):
        self.totals = {}
        self.counts = {}
        self._t0 = time.perf_counter()

    @contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        wall = time.perf_counter() - self._t0
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        name_w = max([len("section")] + [len(n) for n, _ in rows])
        lines = [
            "=== Training profile (per-section wall-clock) ===",
            f"{'section':<{name_w}}  {'count':>7}  {'total s':>9}  "
            f"{'mean ms':>9}  {'% wall':>6}",
        ]
        for name, tot in rows:
            c = self.counts[name]
            lines.append(f"{name:<{name_w}}  {c:>7}  {tot:>9.3f}  "
                         f"{tot / c * 1e3:>9.2f}  {100 * tot / wall:>5.1f}%")
        lines.append(f"{'(total wall)':<{name_w}}  {'':>7}  {wall:>9.3f}")
        return "\n".join(lines)


class TrainingProfile:
    """``torch.profiler`` over a training run on ``device``: CPU activity,
    and CUDA activity on the card. ``stop()`` writes the chrome trace to
    ``<output_dir>/profile/trace.json`` (``name``: a rank's own under a data
    axis) and returns the key-averages table, sorted by self device time on
    the card (self CPU time otherwise)."""

    def __init__(self, output_dir: str, device: torch.device, row_limit: int = 20,
                 name: str = "trace.json"):
        self.dir = os.path.join(output_dir, "profile")
        self.name = name
        self.cuda = device.type == "cuda"
        self.row_limit = row_limit
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts, acc_events=True)
        self.trace_path: Optional[str] = None

    def start(self) -> None:
        self.prof.start()

    def stop(self) -> str:
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self.trace_path = os.path.join(self.dir, self.name)
        self.prof.export_chrome_trace(self.trace_path)
        key = "self_cuda_time_total" if self.cuda else "self_cpu_time_total"
        return self.prof.key_averages().table(sort_by=key, row_limit=self.row_limit)
