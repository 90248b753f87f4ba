"""The run's last lines: one JSON object last on standard output with the
contract's keys (the compared numbers under ``checks``, last), each
compared number beside its limit last on standard error; no result without
a card or with JAX loaded."""

import json
import sys
import time
import types
from pathlib import Path

import pytest

from bench_cases import tiny
from harness import driver, manifest

BENCH = Path(__file__).resolve().parents[1]
CELL = "mnist-acgan-mlp.gc-k1.b600"


@pytest.fixture
def run_py():
    """run.py as a module."""
    return manifest.load_file(BENCH / "run.py", "run_cli")


def _args(cell=CELL):
    return ["--workload", cell, "--seed", "2147483713", "--seconds", "0.1", "--trace", "0"]


@pytest.fixture
def fake_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


def test_a_cpu_run_prints_the_contract_last(run_py, fake_card, monkeypatch, capsys, data_root):
    """The whole harness on the CPU at a tiny size, in the card's place. It
    leaves the process's cores and torch's threads as it found them."""
    import os
    import torch
    real = driver.run
    host = (os.sched_getaffinity(0), torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS"))

    def on_cpu(cell, seed, seconds, trace, t0, **kw):
        return real(cell, seed, seconds, trace, t0, device="cpu",
                    overrides=tiny(cell, data_root), **kw)
    monkeypatch.setattr(run_py.driver, "run", on_cpu)
    assert run_py.main(_args()) == 0
    assert (os.sched_getaffinity(0), torch.get_num_threads(),
            os.environ.get("OMP_NUM_THREADS")) == host
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    assert list(last)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last)[-1] == "checks"
    assert last["correct"] is True and last["attempted"] > 0 and last["failed"] == 0
    assert set(last["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for name, m in last["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(last["metrics"]) <= set(manifest.cell_metrics(CELL, "end_to_end"))
    tail = err.strip().splitlines()[-len(last["checks"]):]
    for line, (name, c) in zip(tail, last["checks"].items()):
        assert line == f"check {name}: {c['value']!r} (limit {c['limit']!r})"


def test_no_result_without_a_card(run_py, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run_py.main(_args()) != 0
    assert capsys.readouterr().out.strip() == ""


def test_no_result_with_jax_loaded(run_py, fake_card, monkeypatch, capsys):
    fake = {"correct": True, "attempted": 1, "failed": 0, "metrics": {}, "device": {},
            "checks": {}}
    monkeypatch.setattr(run_py.driver, "run", lambda *a, **k: fake)
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run_py.main(_args()) != 0
    out, err = capsys.readouterr()
    assert out.strip() == "" and "jax" in err


def test_unknown_cell_is_refused(run_py, capsys):
    assert run_py.main(_args("no-such.cell")) != 0
    assert capsys.readouterr().out.strip() == ""


def test_seconds_bound_the_window(data_root):
    """Whole epochs until the seconds have passed, then the window closes."""
    t0 = time.time()
    res = driver.run(CELL, 4, 1.0, False, t0, device="cpu", overrides=tiny(CELL, data_root),
                     log=lambda *a: None)
    rate = res["metrics"]["samples_per_s"]["value"]
    assert res["attempted"] * 16 / rate >= 1.0
