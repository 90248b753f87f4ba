"""Readings that set the upper ends of a cell's limits: the reference put in
the program's place and computed in the precision just below the
configuration's (TF32 for fp32 with TF32 off, float8 e4m3 for bf16), and
the reference with half of each batch left out and the mean taken over
the rest. Each is compared with the reference as a run compares the
program (harness/check.py). A step that returns its state unchanged reads
``change_gap.d`` and ``change_gap.g`` 1 by construction and needs no run.

    python3 -m harness.control <cell> <seed> ... (from benchmark/)

prints one JSON line a seed: the control's and the fault's numbers, and the
epsilon gap of an accountant that counts one epoch fewer than were run.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Optional

import torch

from . import check, driver, manifest

LOWER = {"fp32": "tf32", "bf16": "fp8"}


def as_readings(out: dict, init: Dict[str, torch.Tensor]) -> dict:
    """A reference output in the form of the program's readings."""
    return {"losses": out["losses"], "grad1": check.norms(out["grad1"]),
            "change": check.norms({k: v - init[k].to(v.device) for k, v in out["params"].items()})}


def readings(cell: str, seed: int, device: str = "cuda", overrides: Optional[dict] = None,
             window_steps: Optional[int] = None) -> dict:
    prep = driver.prepare(cell, seed, device, overrides)
    inputs = driver.reference_inputs(prep)
    init = driver.initial_leaves(inputs)
    cfg, bs = prep.cfg, prep.batch
    mod = manifest.reference(cfg["reference"])
    prec = cfg["precision"]
    with driver._tf32_off():
        ref = mod.steps(inputs, prep.segments, prec=prec)
        low = mod.steps(inputs, prep.segments, prec=LOWER[prec])
        half = mod.steps(inputs, prep.segments, prec=prec, fault="half_batch")
    out = {"cell": cell, "seed": seed,
           "control": check.compare(as_readings(low, init), ref, init),
           "half_batch": check.compare(as_readings(half, init), ref, init),
           "unchanged_state": {"change_gap.d": 1.0, "change_gap.g": 1.0}}
    from reference import rdp
    steps = window_steps or 100 * int(cfg["train_set_size"] // bs)
    q, n_b = bs / cfg["train_set_size"], cfg["train_set_size"] // bs
    orders = rdp.orders(cfg["rdp_orders"])
    full = rdp.epsilon(q, cfg["sigma"], steps, cfg["delta"], orders)
    short = rdp.epsilon(q, cfg["sigma"], steps - n_b, cfg["delta"], orders)
    out["epoch_uncounted"] = {"eps_gap": abs(short - full) / full, "steps": steps}
    return out


if __name__ == "__main__":
    cell = sys.argv[1]
    for s in sys.argv[2:]:
        print(json.dumps(readings(cell, int(s))), flush=True)
