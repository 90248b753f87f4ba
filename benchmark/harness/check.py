"""How a run's ``correct`` is decided: the program's first training steps,
driven through the window's own runner call and feed, against the plain
reference's, and the accountant's epsilon against plain RDP.

The numbers compared (each against the limit the cell's workload file
states; a run is correct when none passes its limit):

- ``loss_gap``: over the check's segments (the runner calls that drive the
  first steps), the largest relative gap of the segment's mean loss
  vector (each loss the program logs and the reference computes: D's real,
  fake and aux losses, the penalty, G's adversarial and aux losses; a K1
  launch of several steps reports only their sum):
  ||L_prog - L_ref|| / ||L_ref||;
- ``loss_gap.first``: the same over the first segment alone, one step from
  the same weights on both sides, so that it reads the forward's rounding
  and not what later steps make of the first update's;
- ``grad_gap.d`` / ``grad_gap.g``: D's and G's first gradient as the
  optimizer got it (the program's from its Adam moment after one step,
  m / (1 - b1)), by the model's worst leaf: | ||g_prog|| - ||g_ref|| | /
  max(||g_ref||, the model's median leaf's ||g_ref||);
- ``change_gap.d`` / ``change_gap.g``: each model's parameter change over
  the steps, by its worst leaf, measured the same way;
- ``eps_gap``: |eps_prog - eps_ref| / eps_ref for the D steps the window ran.

Leaves whose reference gradient is under a thousandth of their model's
median leaf are left out of the gradient and change gaps (round-off alone
moves them under Adam).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

ZERO_GRAD_SHARE = 1e-3


def _median(xs):
    s = sorted(xs)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in t.items()}


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], keep, side: str) -> float:
    """The worst leaf of one model (``side`` "d:" or "g:"): | |p| - |r| |
    over max(|r|, the model's median |r|)."""
    names = [k for k in ref if k.startswith(side)]
    if not names:
        return 0.0
    med = _median([ref[k] for k in names])
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in names if k in keep),
               default=0.0)


def kept_leaves(ref_grad: Dict[str, float]):
    keep = set()
    for side in ("d:", "g:"):
        names = [k for k in ref_grad if k.startswith(side)]
        if names:
            med = _median([ref_grad[k] for k in names])
            keep |= {k for k in names if ref_grad[k] >= ZERO_GRAD_SHARE * med}
    return keep


def loss_gap(prog_losses, ref_losses) -> float:
    worst = 0.0
    for p, r in zip(prog_losses, ref_losses):
        keys = [k for k in r if k in p]
        num = math.sqrt(sum((p[k] - r[k]) ** 2 for k in keys))
        den = math.sqrt(sum(r[k] ** 2 for k in keys))
        worst = max(worst, num / max(den, 1e-30))
    return worst


def compare(prog: dict, ref: dict, init: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The gaps of the program's readings (``prog``: losses, grad1 and
    change norms by leaf) against the reference's output (``ref``: losses,
    grad1 and params tensors; ``init`` the initial params by leaf)."""
    ref_grad = norms(ref["grad1"])
    ref_change = {k: float(torch.linalg.vector_norm((v.double() - init[k].to(v.device).double())))
                  for k, v in ref["params"].items()}
    keep = kept_leaves(ref_grad)
    grads = {k: v for k, v in ref_grad.items() if k in prog["grad1"]}
    out = {"loss_gap": loss_gap(prog["losses"], ref["losses"]),
           "loss_gap.first": loss_gap(prog["losses"][:1], ref["losses"][:1])}
    for side, model in (("d:", "d"), ("g:", "g")):
        out[f"grad_gap.{model}"] = leaf_gap(prog["grad1"], grads, keep, side)
        out[f"change_gap.{model}"] = leaf_gap(prog["change"], ref_change, keep, side)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(name in numbers and math.isfinite(numbers[name]) and numbers[name] <= limit
               for name, limit in limits.items())
