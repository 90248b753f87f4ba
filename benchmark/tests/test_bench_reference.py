"""The plain reference against the port at tiny sizes on the CPU: whole
runs through the harness, the port on its plain kernel versions, and the
reference's numbers held to each cell's limits.

At two rows a batch in bf16 the G's smallest leaves (the last conv's
bias, a sum over 12,288 output pixels, and the last GroupNorm) carry bf16
rounding of several percent of their norm, and a batch mean of two rows
moves the step's losses by bf16 rounding of its fakes, where 512 rows
average both down: in the bf16 cells the G's gradient gap is held to 0.15
and the loss gaps to 1e-3 here (the cells' limits are for B 512).
"""

import time

import pytest

from bench_cases import CELLS, tiny
from harness import driver, manifest

TINY_BF16 = {"grad_gap.g": 0.15, "loss_gap": 1e-3, "loss_gap.first": 1e-3}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell, data_root):
    res = driver.run(cell, 20231018, 0.2, False, time.time(), device="cpu",
                     overrides=tiny(cell, data_root), log=lambda *a: None)
    limits = manifest.workload(cell)["check"]["limits"]
    got = {k: v["value"] for k, v in res["checks"].items()}
    bf16 = manifest.config(manifest.workload(cell)["config"])["precision"] == "bf16"
    for name, limit in limits.items():
        if bf16 and name in TINY_BF16:
            limit = max(limit, TINY_BF16[name])
        assert got[name] <= limit, (name, got)
    assert res["attempted"] > 0 and res["failed"] == 0
    # On the CPU the metrics of the device's timeline have nothing to read.
    assert set(res["metrics"]) == {name for name, m in
                                   manifest.cell_metrics(cell, "end_to_end").items()
                                   if m["source"] == "host_clock"}


def test_the_seed_gives_the_run(data_root):
    """The same seed gives the same inputs: two runs of one seed check the
    same numbers; another seed reads others."""
    cell = CELLS[0]
    runs = [driver.run(cell, s, 0.1, False, time.time(), device="cpu",
                       overrides=tiny(cell, data_root), log=lambda *a: None)
            for s in (2 ** 31 + 77, 2 ** 31 + 77, 5)]
    vals = [tuple(r["checks"][k]["value"] for k in sorted(r["checks"])) for r in runs]
    assert vals[0] == vals[1] and vals[0] != vals[2]
