"""The control of each cell's check comes out not correct: the reference
put in the program's place and computed in the precision below the
configuration's (TF32 for fp32, float8 e4m3 for bf16), and the reference
with half of each batch left out. At a tiny size on the CPU here; at the
cells' own sizes, on three seeds, on a card (``card``)."""

import pytest

from bench_cases import CELLS, tiny
from harness import check, control, manifest


def _fails(numbers: dict, limits: dict) -> bool:
    return not check.verdict(numbers, {k: v for k, v in limits.items() if k in numbers})


@pytest.mark.parametrize("cell", CELLS)
def test_half_batch_and_an_uncounted_epoch_fail_on_the_cpu(cell, data_root):
    r = control.readings(cell, 17, "cpu", tiny(cell, data_root))
    limits = manifest.workload(cell)["check"]["limits"]
    assert _fails(r["half_batch"], limits), r["half_batch"]
    assert _fails(r["unchanged_state"], limits)
    assert r["epoch_uncounted"]["eps_gap"] > limits["eps_gap"]


def test_the_tf32_control_fails_on_the_cpu(data_root):
    cell = CELLS[0]
    r = control.readings(cell, 17, "cpu", tiny(cell, data_root))
    assert _fails(r["control"], manifest.workload(cell)["check"]["limits"]), r["control"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell, card):
    limits = manifest.workload(cell)["check"]["limits"]
    for seed in (301, 302, 303):
        r = control.readings(cell, seed, "cuda")
        assert _fails(r["control"], limits), (seed, r["control"])
        assert _fails(r["half_batch"], limits), (seed, r["half_batch"])
