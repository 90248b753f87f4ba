"""One run of one cell: set-up, the correctness steps, warm-up, the
measured window over ``Trainer.run``, the traced stretch, the reference
check, and the result.

Set-up, in phases printed before the result (seconds): ``imports`` (torch
and the program), ``cuda`` (the context), ``data`` (the configuration's
data files, made once under ``build/bench_data``, and the benchmark's
initial weights, made on the device from the seed), ``kernel_load`` (the
cell's libraries from the checkout's ``build/``; nvcc only where a library
is missing, its seconds printed apart), ``trainer`` (the program's
``Trainer`` from the cell's flags, as ``python -m
csl_gan_tpu_torch.train`` builds it, with those weights in its state),
``check_steps`` (the first steps, through the runner's own segment call on
the epoch's own permutation and generator, in the workload's segments,
whose losses, first gradient and parameter change the reference checks),
``warm_up`` (the workload's
epochs through the Trainer's own group call, and a sample grid). The
window then runs ``Trainer.run`` over whole epochs until ``seconds`` have
passed (harness/hooks.py).
"""

from __future__ import annotations

import functools
import gc
import importlib
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np

from . import check, manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "csl_gan_tpu")
LOSS_SLOTS = (("d_real_loss", "M_D_REAL"), ("d_fake_loss", "M_D_FAKE"),
              ("d_real_aux_loss", "M_D_RAUX_LOSS"), ("g_adv_loss", "M_G_ADV"),
              ("g_aux_loss", "M_G_AUX"))
LOSS_KEYS = ("d_real_loss", "d_fake_loss", "d_real_aux_loss", "penalty", "g_adv_loss",
             "g_aux_loss")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (the port's name begins with the JAX package's)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def seeds(seed: int) -> dict:
    """The run's seeds, drawn from ``--seed``: the program's manual seed
    (its mean-sample and host streams), the row-permutation stream, the
    per-step stream and the initial weights."""
    s = np.random.SeedSequence(int(seed) % (1 << 64)).generate_state(4, np.uint32)
    return {"manual": int(s[0]) % (1 << 30) + 1, "perm": int(s[1]), "step": int(s[2]),
            "weights": int(s[3])}


def flags_of(wl: dict, overrides: dict) -> list:
    """The workload's flags, with a test's values put in place of some."""
    argv = list(wl["flags"])
    for flag, value in overrides.items():
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    return argv


class Phases:
    def __init__(self, t0: float):
        self.t = t0
        self.seconds = {}

    def done(self, name: str) -> None:
        now = time.time()
        self.seconds[name] = now - self.t
        self.t = now


def _check_options(opt, cfg: dict) -> None:
    """The program runs what the configuration states."""
    for attr, key in cfg.get("program_options", {}).items():
        got, want = getattr(opt, attr), cfg[key]
        same = math.isclose(float(got), float(want), rel_tol=1e-12) \
            if isinstance(want, (int, float)) else got == want
        if not same:
            raise RuntimeError(f"the program runs {attr} = {got!r}; the configuration "
                               f"{cfg['name']} states {want!r}")


def program_steps(trainer, segments, d0: dict, g0: dict) -> dict:
    """The first steps of epoch 0 through the runner's own segment call, in
    ``segments`` (the step counts of consecutive segments; the first is one
    step), on the epoch's permutation and the Trainer's generators. Returns
    each segment's mean losses (a K1 launch sums its steps' losses), the
    first gradient's norm by leaf (from the Adam moment after the first
    step) and each leaf's change."""
    from csl_gan_tpu_torch.ops import pallas_epoch
    from csl_gan_tpu_torch.training.segment_runner import EpochsRunner

    if segments[0] != 1:
        raise ValueError("the first check segment is one step: the first gradient is "
                         "read from the optimizer's state after it")
    runner, opt = trainer.runner, trainer.opt
    k1 = isinstance(runner, EpochsRunner)
    out = {"losses": [], "grad1": {}, "change": {}, "seconds": []}
    if k1:
        perm = runner.epoch_perm(trainer.table, trainer.gen_perm)
    else:
        src, stds = runner.epoch_source(trainer.gen_perm), runner.noise_stds(trainer.state)
    start = 0
    for n in segments:
        t = time.perf_counter()
        if k1:
            trainer.state, met = runner.run_segment(trainer.state, trainer.table, perm,
                                                    trainer.gen, start, start + n)
            m = met.double().cpu()
            losses = {k: float(m[getattr(pallas_epoch, slot)]) / n for k, slot in LOSS_SLOTS}
        else:
            sums = [{}, {}, 0]
            trainer.state = runner.run_segment(trainer.state, src, trainer.gen, start,
                                               start + n, sums, stds)
            losses = {k: float(v) / n for k, v in sums[0].items() if k in LOSS_KEYS}
            losses.update({k: float(v) / max(sums[2], 1) for k, v in sums[1].items()
                           if k in LOSS_KEYS})
        out["losses"].append(losses)
        out["seconds"].append(time.perf_counter() - t)
        if start == 0:
            st = trainer.state
            for side, mu, count in (("d", st.d_mu, st.d_count), ("g", st.g_mu, st.g_count)):
                if count:
                    out["grad1"].update({f"{side}:{k}": v / (1.0 - opt.adam_b1)
                                         for k, v in mu.items()})
            out["grad1"] = check.norms(out["grad1"])
        start += n
    st = trainer.state
    out["change"] = check.norms({**{f"d:{k}": st.d_params[k] - d0[k] for k in d0},
                                 **{f"g:{k}": st.g_params[k] - g0[k] for k in g0}})
    if any(not math.isfinite(v) for v in out["change"].values()):
        raise RuntimeError("the program's parameters are not finite after the first steps")
    return out


@contextmanager
def _tf32_off():
    import torch
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _build_kernels(cfg: dict) -> dict:
    """The configuration's kernel libraries, built into the checkout's
    ``build/`` where missing and loaded; returns each nvcc unit's seconds."""
    from csl_gan_tpu_torch.ops import _build
    _build.build_all(tuple(cfg["kernels"]))
    for name in cfg["kernels"]:
        _build.load(name)
    return dict(_build.build_seconds)


def prepare(cell: str, seed: int, device: str, overrides: Optional[dict] = None):
    """What a run of ``cell`` and its reference both start from: the
    workload, the configuration (with a test's keys put in place), the
    batch size, the data files (made once under ``build/bench_data``), the
    run's seeds and the initial weights, made on ``device`` from the seed."""
    from . import weights
    overrides = overrides or {}
    wl = manifest.workload(cell)
    cfg = {**manifest.config(wl["config"]), **overrides.get("config", {})}
    argv = flags_of(wl, overrides.get("flags", {}))
    data_root = Path(overrides.get("data_root") or
                     manifest.root() / "build" / "bench_data" / cfg["name"])
    files = manifest.dataset(cfg["dataset"]["kind"]).files(
        {**cfg["dataset"], **overrides.get("dataset", {})}, data_root)
    sd = seeds(seed)
    d0, g0 = weights.make(cfg, sd["weights"], device)
    segments = [int(n) for n in overrides.get("segments", wl["check"]["segments"])]
    return SimpleNamespace(cell=cell, wl=wl, cfg=cfg, batch=int(argv[argv.index("-bs") + 1]),
                           files=files, seeds=sd, d0=d0, g0=g0, segments=segments,
                           device=device)


def reference_inputs(prep) -> dict:
    """The reference's inputs: the same data files, seeds and initial
    weights the program was given (the weights as CPU copies)."""
    return {"config": prep.cfg, "device": prep.device, "batch_size": prep.batch,
            "files": prep.files, "perm_seed": prep.seeds["perm"],
            "step_seed": prep.seeds["step"], "manual_seed": prep.seeds["manual"],
            "d0": {k: v.cpu() for k, v in prep.d0.items()},
            "g0": {k: v.cpu() for k, v in prep.g0.items()}, "route": prep.wl.get("route", {})}


def initial_leaves(inputs: dict) -> dict:
    return {**{f"d:{k}": v for k, v in inputs["d0"].items()},
            **{f"g:{k}": v for k, v in inputs["g0"].items()}}


def _trainer(prep, out_dir: Path, dev, overrides: dict):
    """The cell's Trainer from its flags, as ``python -m
    csl_gan_tpu_torch.train`` builds it, on the run's streams, with the
    run's initial weights."""
    from csl_gan_tpu_torch import options
    from csl_gan_tpu_torch.training.loop import Trainer
    wl, cfg, files, sd = prep.wl, prep.cfg, prep.files, prep.seeds
    argv = flags_of(wl, overrides.get("flags", {})) + [
        "--manual_seed", str(sd["manual"]), "-o", str(out_dir), "-ne", str(10 ** 9),
        "--save_every", str(10 ** 9), "--data_path", files["data_path"]]
    if "label_path" in files:
        argv += ["-lp", files["label_path"]]
    if dev.type == "cpu":
        argv += ["--platform", "cpu"]
    opt = options.parse(argv)
    _check_options(opt, cfg)
    trainer = Trainer(opt)
    trainer.gen.manual_seed(sd["step"])
    trainer.gen_perm.manual_seed(sd["perm"])
    _put_weights(trainer, prep.d0, prep.g0)
    return trainer


def _put_weights(trainer, d0: dict, g0: dict) -> None:
    st = trainer.state
    for mine, theirs in ((d0, st.d_params), (g0, st.g_params)):
        if {k: tuple(v.shape) for k, v in mine.items()} != \
                {k: tuple(v.shape) for k, v in theirs.items()}:
            raise RuntimeError("the program's leaves are not the configuration's")
    trainer.state = replace(st, d_params={k: v.clone() for k, v in d0.items()},
                            g_params={k: v.clone() for k, v in g0.items()})


def launch_counters(cfg: dict) -> Dict[str, Callable[[], int]]:
    """The program's own counts of the CUDA launches of some kernel tags
    (``launch_counters`` in the configuration: a function and its
    arguments, such as gn_relu.cu's count for K4 and K5), each as a
    function of no arguments."""
    out = {}
    for tag, spec in cfg.get("launch_counters", {}).items():
        mod_name, attr = spec["call"].split(":")
        fn = getattr(importlib.import_module(mod_name), attr)
        out[tag] = functools.partial(fn, *spec.get("args", []))
    return out


def _measure(trainer, wl: dict, cfg: dict, seconds: float, trace: bool, dev):
    """The window over ``Trainer.run`` (and, under ``trace``, its profiled
    stretch). Returns (window, kernel calls, stretch numbers, the CUDA
    launches that the program counted in the stretch by tag, memory peak)."""
    import torch
    from . import hooks, trace as trace_mod
    spans = hooks.KernelSpans(cfg.get("kernel_entries", {})) if trace else None
    stretch = trace_mod.Stretch(dev) if trace and dev.type == "cuda" else None
    counters = launch_counters(cfg) if stretch is not None else {}
    launched = {}

    @contextmanager
    def profiled():
        before = {tag: f() for tag, f in counters.items()}
        spans.recording = True
        with stretch:
            yield
        spans.recording = False
        launched.update({tag: f() - before[tag] for tag, f in counters.items()})

    window = hooks.Window(trainer, seconds, trace, dev, profiled if stretch else None,
                          int(wl.get("trace_calls", 1)))
    try:
        trainer.run()
    finally:
        window.finish()
        if spans is not None:
            spans.close()
    mem_peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    stats = {}
    if stretch is not None and stretch.prof is not None:
        stats = trace_mod.read(stretch, Path(tempfile.gettempdir()),
                               list(cfg.get("kernel_entries", {})))
    return window, (spans.calls if spans is not None else {}), stats, launched, mem_peak


def run(cell: str, seed: int, seconds: float, trace: bool, t0: float, device: str = "cuda",
        overrides: Optional[dict] = None, plant: Optional[Callable] = None,
        log=print) -> dict:
    """One run; returns the result line's object. ``overrides`` (tests):
    "flags" {flag: value}, "config" {key: value} (what the flags change),
    "dataset" {key: value}, "data_root", "segments".
    ``plant(trainer)`` (tests) breaks the program before the first steps."""
    overrides = overrides or {}
    ph = Phases(t0)

    import torch
    from csl_gan_tpu_torch.training.segment_runner import EpochsRunner
    from . import peaks
    ph.done("imports")

    dev = torch.device(device)
    card = None
    if dev.type == "cuda":
        torch.cuda.init()
        card = torch.cuda.get_device_name(0)
        torch.ones(1, device=dev).sum().item()
    ph.done("cuda")
    prep = prepare(cell, seed, device, overrides)
    wl, cfg = prep.wl, prep.cfg
    ph.done("data")
    nvcc = _build_kernels(cfg) if dev.type == "cuda" else {}
    ph.done("kernel_load")

    out_dir = Path(tempfile.gettempdir()) / "csl_gan_bench" / cell
    shutil.rmtree(out_dir, ignore_errors=True)
    trainer = _trainer(prep, out_dir, dev, overrides)
    ph.done("trainer")

    if plant is not None:
        plant(trainer)
    prog = program_steps(trainer, prep.segments, prep.d0, prep.g0)
    inputs = reference_inputs(prep)
    del prep.d0, prep.g0
    ph.done("check_steps")

    warm = wl["warmup"]
    if warm.get("epochs"):
        trainer._run_group(0, int(warm["epochs"]))
    if warm.get("grid"):
        trainer.sample(0, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ph.done("warm_up")

    window, kernel_calls, stats, launched, mem_peak = _measure(trainer, wl, cfg, seconds,
                                                               trace, dev)
    ph.done("after: window, trace read")

    k1 = isinstance(trainer.runner, EpochsRunner)
    opt = trainer.opt
    bs, n_batches = int(opt.batch_size), int(trainer.n_batches)
    if bs != prep.batch:
        raise RuntimeError(f"the program runs batch {bs}; the workload states {prep.batch}")
    d_steps = window.epochs * n_batches if k1 else window.d_steps
    g_steps = d_steps if k1 else window.g_steps
    window_s = window.t_end - window.t_start
    eps_prog, acc_steps = trainer.accountant.get_privacy_spent(opt.delta)[0], \
        trainer.accountant.steps
    e2e = {"samples_per_s": d_steps * bs / window_s, "setup_s": window.wall_start - t0}
    d_ms = window.d_step_ms()
    if d_ms and not k1:
        e2e["d_step_ms_p95"] = statistics.quantiles(d_ms, n=100, method="inclusive")[94]

    stretch = window.stretch or {}
    s_d = stretch.get("epochs", 0) * n_batches if k1 else stretch.get("d_steps", 0)
    s_g = s_d if k1 else stretch.get("g_steps", 0)
    numbers_of_run = SimpleNamespace(
        cfg=cfg, workload=wl, batch=bs, n_batches=n_batches, k1=k1,
        window_s=window_s - stretch.get("wall_s", 0.0),
        d_steps=d_steps - s_d, g_steps=g_steps - s_g,
        cpu_s=(window.cpu_end - window.cpu_start) - stretch.get("cpu_s", 0.0),
        epoch_s=sum(window.epoch_ms) / 1e3, trace=stats, kernel_calls=kernel_calls,
        launched=launched, counts=manifest.counts(cfg), peaks=peaks.peaks(card),
        memory_peak_bytes=mem_peak)
    per_layer = {}
    if trace:
        for name, m in manifest.cell_metrics(cell, "per_layer").items():
            value = manifest.metric_reader(name).read(numbers_of_run)
            if value is not None:
                per_layer[name] = {"value": value, "unit": m["unit"]}
    epoch_ms = [round(x, 1) for x in window.epoch_ms]
    launch_check = {tag: {"program": n, "trace": stats.get("kernel_n", {}).get(tag)}
                    for tag, n in launched.items()}

    # The program's state goes before the reference runs, so that the
    # reference does not set the process's memory peak.
    del trainer, window, numbers_of_run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ph.done("after: metrics, free")

    from reference import rdp
    with _tf32_off():
        ref = manifest.reference(cfg["reference"]).steps(inputs, prep.segments)
    ph.done("after: reference")
    numbers = check.compare(prog, ref, initial_leaves(inputs))
    eps_ref = rdp.epsilon(bs / cfg["train_set_size"], cfg["sigma"], d_steps, cfg["delta"],
                          rdp.orders(cfg["rdp_orders"]))
    numbers["eps_gap"] = abs(eps_prog - eps_ref) / max(eps_ref, 1e-300)
    if acc_steps != d_steps:
        numbers["eps_gap"] = max(numbers["eps_gap"], 1.0)
    limits = wl["check"]["limits"]
    shutil.rmtree(out_dir, ignore_errors=True)
    ph.done("after: compare")

    log(json.dumps({"setup_phases": {k: round(v, 4) for k, v in ph.seconds.items()},
                    "nvcc_seconds": nvcc, "check_step_s": prog["seconds"],
                    "stretch": stretch, "launches": launch_check, "epoch_ms": epoch_ms,
                    "window_s": window_s, "d_steps": d_steps, "g_steps": g_steps,
                    "epsilon": eps_prog, "epsilon_reference": eps_ref, "numbers": numbers}))
    metrics = per_layer if trace else {
        name: {"value": e2e[name], "unit": m["unit"]}
        for name, m in manifest.cell_metrics(cell, "end_to_end").items() if name in e2e}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type, "kind": card or "cpu",
                   "count": 1, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": check.verdict(numbers, limits), "attempted": int(d_steps),
              "failed": 0, "metrics": metrics, "device": device_info}
    if trace and stats:
        device_info.update(busy_s=stats["busy_s"], window_s=stats["span_s"])
        result["breakdown"] = {"device_ops": stats["device_ops"],
                               "idle_gaps": stats["idle_gaps"]}
    result["checks"] = {name: {"value": numbers.get(name, float("nan")), "limit": limit}
                        for name, limit in limits.items()}
    return result


def cache_env(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / "build" / "bench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "cuda"))
