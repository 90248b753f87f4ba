"""A configuration, a cell and a per-layer metric added as new files (and
entries in BENCHMARK.json) are found and run by the harness, with no file
of the benchmark edited."""

import hashlib
import json
import shutil
import time
from pathlib import Path
from types import SimpleNamespace

from bench_cases import tiny
from harness import driver, manifest

ROOT = Path(__file__).resolve().parents[2]


def _digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_and_run(tmp_path, monkeypatch, data_root):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    before = _digests(root)

    # A configuration: the MNIST pair under another name, with its counts.
    cfg = json.loads((root / "benchmark/configs/mnist-acgan-mlp.json").read_text())
    cfg.update(name="mnist-acgan-mlp-copy", counts="mnist-acgan-mlp-copy.counts.py")
    (root / "benchmark/configs/mnist-acgan-mlp-copy.json").write_text(json.dumps(cfg))
    shutil.copy(root / "benchmark/configs/mnist-acgan-mlp.counts.py",
                root / "benchmark/configs/mnist-acgan-mlp-copy.counts.py")
    # A cell on it, and a per-layer metric.
    wl = json.loads((root / "benchmark/workloads/mnist-acgan-mlp.gc-k1.b600.json").read_text())
    wl.update(name="mnist-acgan-mlp-copy.gc-k1.b160", config="mnist-acgan-mlp-copy",
              traffic="gc-k1.b160")
    (root / f"benchmark/workloads/{wl['name']}.json").write_text(json.dumps(wl))
    (root / "benchmark/metrics/epochs_per_s.py").write_text(
        '"""Epochs over the window, the stretch left out (1/s)."""\n\n\n'
        "def read(run):\n    return run.d_steps / run.n_batches / run.window_s\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": cfg["name"], "source": "https://example.org/copy",
                         "file": "benchmark/configs/mnist-acgan-mlp-copy.json", "reduced": [],
                         "why": "a copy"})
    m["workloads"].append({"name": wl["name"], "config": cfg["name"], "traffic": wl["traffic"],
                           "chips": 1, "why": "a copy"})
    m["per_layer"].append({"name": "epochs_per_s", "unit": "1/s", "better": "higher",
                           "source": "host_clock", "layer": "entry point: Trainer.run",
                           "moves": "samples_per_s", "workloads": [wl["name"]]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    monkeypatch.setenv("BENCH_ROOT", str(root))
    assert wl["name"] in [w["name"] for w in manifest.manifest()["workloads"]]
    assert set(manifest.cell_metrics(wl["name"], "per_layer")) >= {"epochs_per_s"}
    res = driver.run(wl["name"], 9, 0.1, False, time.time(), device="cpu",
                     overrides=tiny("mnist", data_root), log=lambda *a: None)
    assert res["correct"] is True
    reader = manifest.metric_reader("epochs_per_s")
    assert reader.read(SimpleNamespace(d_steps=200, n_batches=100, window_s=0.5)) == 4.0
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
