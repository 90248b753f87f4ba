"""Where the benchmark finds its parts, by the names in ``BENCHMARK.json``:

- ``workloads/<cell>.json``: the cell's configuration, the program flags
  that make its traffic, its warm-up, its reference route and the limits of
  its correctness check;
- ``configs/<config>.json``: the model, its precision and training
  constants, source, ``reduced``, ``assumed``, leaves and the stated draw
  order; it names its reference module (``reference/<name>.py``), its
  counts file (``configs/<config>.counts.py``) and its data set kind
  (``datasets/<kind>.py``);
- ``metrics/<metric>.py``: one reader per per-layer metric.

A later configuration, cell or metric is new files here and entries in
``BENCHMARK.json``; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def root() -> Path:
    """The checkout the benchmark runs in (``BENCH_ROOT`` overrides it, for
    tests that lay out a copy)."""
    return Path(os.environ.get("BENCH_ROOT", ROOT))


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return _json(root() / "BENCHMARK.json")


def workload(name: str) -> dict:
    return _json(root() / "benchmark" / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return _json(root() / "benchmark" / "configs" / f"{name}.json")


def load_file(path: Path, tag: str) -> ModuleType:
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(f"bench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def counts(cfg: dict) -> ModuleType:
    return load_file(root() / "benchmark" / "configs" / cfg["counts"],
                     cfg["name"].replace("-", "_").replace(".", "_") + "_counts")


def dataset(kind: str) -> ModuleType:
    return load_file(root() / "benchmark" / "datasets" / f"{kind}.py",
                     "dataset_" + kind.replace("-", "_"))


def reference(name: str) -> ModuleType:
    return importlib.import_module(f"reference.{name}")


def metric_reader(name: str) -> ModuleType:
    return load_file(root() / "benchmark" / "metrics" / f"{name}.py",
                     "metric_" + name.replace(".", "_").replace("-", "_"))


def cell_metrics(cell: str, section: str) -> Dict[str, dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    manifest gives this cell: those without a ``workloads`` list, and those
    whose list names it."""
    out = {}
    for m in manifest()[section]:
        cells: Optional[list] = m.get("workloads")
        if cells is None or cell in cells:
            out[m["name"]] = m
    return out
