"""The benchmark's own spans and events around the program's calls.

The program gives no spans yet, so the harness wraps, on the objects of one
run and for that run only:

- ``Trainer._epochs``: the window opens on entry (after a device sync) and
  closes after it returns (the last epoch's end, synchronized);
- ``Trainer._save``: the save on the way out lies outside the window and is
  not written (a checkpoint stall is a traffic mix of its own);
- the runner's ``run``: each call's epoch events (``runner.epoch_events``)
  are kept; once the deadline has passed, the Trainer's ``n_epochs`` is set
  to the epochs run, so the epoch loop ends after this group; under
  ``--trace 1`` the workload's ``trace_calls`` calls and their epoch
  boundaries, from a third of the window on, are the profiled stretch, and
  the window runs ``seconds`` besides;
- ``StepBuilder.d_core``: a CUDA event as each D step is called (the
  d_step_ms_p95 intervals), and a D-step count; ``g_core``: a G-update
  count;
- under ``--trace 1`` only, record_function ranges named ``bench.<what>``
  around the D and G steps, the log flush, the sample grid, the accountant
  and every kernel entry the configuration names (``kernel_entries``), whose
  calls' argument shapes are kept for the counts.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import sys
import time
from typing import Callable, Dict, List, Optional

import torch


def summary(x):
    """A call argument as the counts files read it."""
    if isinstance(x, torch.Tensor):
        return {"shape": list(x.shape), "itemsize": x.element_size()}
    if isinstance(x, (list, tuple)):
        return [summary(v) for v in x]
    if isinstance(x, (bool, int, float)):
        return x
    return None


def _range(name: str, on: bool):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class KernelSpans:
    """record_function ranges ``bench.<tag>`` around each kernel entry,
    wherever the program's modules refer to it, and the calls' summaries
    while ``recording``."""

    def __init__(self, entries: Dict[str, str]):
        self.calls: Dict[str, List[dict]] = {tag: [] for tag in entries}
        self.recording = False
        self._undo = []
        for tag, where in entries.items():
            mod_name, attr = where.split(":")
            original = getattr(importlib.import_module(mod_name), attr)
            wrapped = self._wrap(tag, original)
            for mod in list(sys.modules.values()):
                name = getattr(mod, "__name__", "") or ""
                if name.split(".")[0] == mod_name.split(".")[0] and \
                        getattr(mod, attr, None) is original:
                    self._undo.append((mod, attr, original))
                    setattr(mod, attr, wrapped)

    def _wrap(self, tag: str, fn: Callable):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if self.recording:
                self.calls[tag].append({"args": [summary(a) for a in args],
                                        "kwargs": {k: summary(v) for k, v in kwargs.items()}})
            with torch.profiler.record_function(f"bench.{tag}"):
                return fn(*args, **kwargs)
        # The entries keep their launch counters as attributes of their own
        # name, which now resolves to the wrapper.
        call.__dict__.update(fn.__dict__)
        return call

    def close(self) -> None:
        for mod, attr, original in self._undo:
            for k, v in getattr(mod, attr).__dict__.items():
                if k != "__wrapped__":
                    setattr(original, k, v)
            setattr(mod, attr, original)
        self._undo = []


class Window:
    """The measured window over ``Trainer.run`` (see the module docstring)."""

    def __init__(self, trainer, seconds: float, trace: bool, device: torch.device,
                 stretch: Optional[Callable] = None, stretch_calls: int = 1):
        self.trainer, self.seconds, self.trace = trainer, seconds, trace
        self.stretch_calls = stretch_calls
        self.cuda = device.type == "cuda"
        self.stretch_fn = stretch
        self.d_events: List = []
        self.d_steps = self.g_steps = 0
        self.epochs = 0
        self.epoch_ms: List[float] = []
        self.calls = 0
        self.groups: List[tuple] = []       # (epoch events of a runner call, in the stretch)
        self._open = None
        self.t_start = self.t_end = None
        self.cpu_start = self.cpu_end = None
        self.end_event = None
        self.stretch = None          # dict of the profiled stretch's numbers
        runner, builder = trainer.runner, trainer.builder
        self._orig = {"epochs": trainer._epochs, "save": trainer._save, "run": runner.run,
                      "d_core": builder.d_core, "g_core": builder.g_core}
        trainer._epochs = self._epochs
        trainer._save = self._save
        runner.run = self._run
        builder.d_core = self._d_core
        builder.g_core = self._g_core
        if trace:
            self._orig.update(flush=trainer._flush_log, sample=trainer.sample)
            trainer._flush_log = self._spanned("bench.log_flush", trainer._flush_log)
            trainer.sample = self._spanned("bench.grid", trainer.sample)
            acc = trainer.accountant
            if acc is not None:
                self._orig.update(acc_step=acc.step, acc_spent=acc.get_privacy_spent)
                acc.step = self._spanned("bench.accounting", acc.step)
                acc.get_privacy_spent = self._spanned("bench.accounting", acc.get_privacy_spent)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @staticmethod
    def _spanned(name: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    def _epochs(self, preempted):
        self._sync()
        self.t_start = time.perf_counter()
        self.wall_start = time.time()
        self.cpu_start = time.thread_time()
        self.deadline = self.t_start + self.seconds
        out = self._orig["epochs"](preempted)
        if self._open is not None:
            self._close_stretch()
        if self.cuda:
            self.end_event = torch.cuda.Event(enable_timing=True)
            self.end_event.record()
        self._sync()
        self.t_end = time.perf_counter()
        self.cpu_end = time.thread_time()
        return out

    def _save(self, *args, **kwargs):
        """The exit save is not written."""

    def _run(self, *args, **kwargs):
        k = args[-1]
        self.calls += 1
        if self._open is not None and self._open_calls >= self.stretch_calls:
            self._close_stretch()
        # The stretch: ``stretch_calls`` runner calls and their epoch
        # boundaries, from the first call (the second on) once a third of
        # the window has passed, so that it is steady; the window then runs
        # its full length besides.
        if (self.trace and self.stretch_fn is not None and self.stretch is None
                and self._open is None and self.calls >= 2
                and time.perf_counter() - self.t_start >= self.seconds / 3):
            self._sync()
            before = (self.d_steps, self.g_steps, time.perf_counter(), time.thread_time())
            ctx = self.stretch_fn()
            ctx.__enter__()
            self._open, self._open_calls, self._open_epochs = (ctx, before), 0, 0
        in_stretch = self._open is not None
        with _range("bench.epoch", self.trace):
            out = self._orig["run"](*args, **kwargs)
        if in_stretch:
            self._open_calls += 1
            self._open_epochs += k
        self.epochs += k
        self.groups.append((list(self.trainer.runner.epoch_events), in_stretch))
        waiting = self.trace and self.stretch_fn is not None and self.stretch is None
        if time.perf_counter() >= self.deadline and not waiting:
            self.trainer.opt.n_epochs = self.trainer.start_epoch + self.epochs
        return out

    def _close_stretch(self) -> None:
        (ctx, before), self._open = self._open, None
        self._sync()
        steps = (self.d_steps - before[0], self.g_steps - before[1])
        ctx.__exit__(None, None, None)
        # The profiler's own start and stop count with the stretch, which
        # the window's rates leave out.
        self.stretch = {"d_steps": steps[0], "g_steps": steps[1], "epochs": self._open_epochs,
                        "wall_s": time.perf_counter() - before[2],
                        "cpu_s": time.thread_time() - before[3]}
        self.deadline += self.stretch["wall_s"]

    def finish(self) -> None:
        """After ``Trainer.run``: the stretch if still open, the last call's
        epoch times, and the program's own methods back."""
        if self._open is not None:
            self._close_stretch()
        self.epoch_ms = [a.elapsed_time(b) for evs, stretch in self.groups if not stretch
                         for a, b in evs]
        tr = self.trainer
        for key, obj, attr in (("epochs", tr, "_epochs"), ("save", tr, "_save"),
                               ("run", tr.runner, "run"), ("d_core", tr.builder, "d_core"),
                               ("g_core", tr.builder, "g_core"), ("flush", tr, "_flush_log"),
                               ("sample", tr, "sample"), ("acc_step", tr.accountant, "step"),
                               ("acc_spent", tr.accountant, "get_privacy_spent")):
            if key in self._orig:
                setattr(obj, attr, self._orig[key])

    def _d_core(self, *args, **kwargs):
        self.d_steps += 1
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.d_events.append(ev)
        with _range("bench.d_step", self.trace):
            return self._orig["d_core"](*args, **kwargs)

    def _g_core(self, *args, **kwargs):
        self.g_steps += 1
        with _range("bench.g_step", self.trace):
            return self._orig["g_core"](*args, **kwargs)

    def d_step_ms(self) -> List[float]:
        """Device-timeline intervals between consecutive D-step events, the
        last to the window's end."""
        if not self.d_events or self.end_event is None:
            return []
        evs = self.d_events + [self.end_event]
        return [a.elapsed_time(b) for a, b in zip(evs[:-1], evs[1:])]
