"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import json
import math
import re

import pytest

from harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return manifest.manifest()


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert m["paths"] == ["benchmark"] and m["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len(json.dumps(m)) <= 64 * 1024


def test_names_and_units(m):
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for section in ("configs", "workloads"):
        got = [n for s, n in names if s == section]
        assert len(got) == len(set(got))
    metrics = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))


def test_entry_keys(m):
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        cfg = manifest.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and key in cfg and not key.endswith(("_dim", "_rank"))
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        wl = manifest.workload(w["name"])
        assert (wl["config"], wl["traffic"], wl["chips"]) == (w["config"], w["traffic"], 1)
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in m["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_config_is_used_and_pairs_are_unique(m):
    used = {w["config"] for w in m["workloads"]}
    assert used == {c["name"] for c in m["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in m["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_cell_reports_setup_another_e2e_and_a_layer(m):
    for w in m["workloads"]:
        e2e = manifest.cell_metrics(w["name"], "end_to_end")
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.cell_metrics(w["name"], "per_layer")


def test_moves_is_reported_in_each_listed_cell(m):
    cells = {w["name"] for w in m["workloads"]}
    for e in m["per_layer"]:
        assert "workloads" in e and set(e["workloads"]) <= cells
        for cell in e["workloads"]:
            assert e["moves"] in manifest.cell_metrics(cell, "end_to_end"), (e["name"], cell)


def test_layers_of_one_name_and_a_reader_each(m):
    for e in m["per_layer"]:
        reader = manifest.metric_reader(e["name"])
        assert callable(reader.read)
        if e["name"].endswith("_roofline"):
            tag = e["name"][:-len("_roofline")]
            for cell in e["workloads"]:
                cfg = manifest.config(manifest.workload(cell)["config"])
                assert tag in cfg["kernel_entries"] and tag in manifest.counts(cfg).KERNELS
                assert e["unit"] == "%"


def test_a_full_check_fits_its_time(m):
    cells = 24
    total = (2 + 14 * cells) * (m["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_bounds_are_shares_within_the_contract(m):
    setup = next(e for e in m["end_to_end"] if e["name"] == "setup_s")
    assert setup["bound"] <= 0.25
    for e in m["end_to_end"]:
        assert math.isfinite(e["bound"])
