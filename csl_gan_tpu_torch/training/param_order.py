"""Mapping between torch's parameter order and the JAX package's leaf order
(the port's copy of the JAX package's training/param_order.py).

Per-layer CLI lists (``-cpl``) follow torch's ``model.parameters()`` order:
modules in definition order, weight before bias. The port keeps per-leaf
vectors (clip thresholds, norms, noise stds) in the JAX leaf order, bias
before kernel in each module (``StepBuilder.d_leaves``), so that they compare
with the JAX package's element by element. Names here are torch state-dict
names; the torch order is the discriminator's ``state_dict()`` order.
"""

from __future__ import annotations

import re
from typing import List, Sequence


def from_torch_order(values: Sequence[float], leaves: Sequence[str],
                     torch_names: Sequence[str]) -> List[float]:
    """Reorder a torch-order per-layer vector into leaf order."""
    if len(values) != len(leaves):
        raise ValueError(f"per-layer vector has {len(values)} entries but model "
                         f"has {len(leaves)} parameters")
    by_name = dict(zip(torch_names, values))
    return [float(by_name[k]) for k in leaves]


def to_torch_order(values: Sequence[float], leaves: Sequence[str],
                   torch_names: Sequence[str]) -> List[float]:
    """Reorder a leaf-order per-layer vector into torch order (for logs)."""
    by_name = dict(zip(leaves, values))
    return [float(by_name[k]) for k in torch_names]


def _conv_index(name: str):
    m = re.search(r"TorchConv_(\d+)\.", name)
    return int(m.group(1)) if m else None


def default_clipping_per_layer(leaves: Sequence[str]) -> List[float]:
    """Conditional/size-aware generalization of the CelebA -cpl default
    [1000, 200, 1000, 100, 1000, 100, 1000, 5, 2500] (reference
    options.py:80), by leaf role: conv kernels 1000; conv biases 200 (first) /
    100 (mid) / 5 (last); critic and aux-head kernels 2500; aux-head bias 5.
    Returns the vector in leaf order."""
    convs = [ci for ci in map(_conv_index, leaves) if ci is not None]
    n_convs = max(convs) + 1 if convs else 0
    vals = []
    for name in leaves:
        ci, is_weight = _conv_index(name), name.endswith(".weight")
        if ci is not None:
            vals.append(1000.0 if is_weight else
                        200.0 if ci == 0 else 5.0 if ci == n_convs - 1 else 100.0)
        else:
            vals.append(2500.0 if is_weight else 5.0)
    return vals
