"""Initial weights of a run, made by the benchmark from the seed on the
device in one draw: each leaf that the configuration gives a bound b is
U(-b, b) (b = 1 / sqrt(fan-in), PyTorch's default for linear and conv
layers), the others are the constant it names (GroupNorm's 1 and 0)."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

Params = Dict[str, torch.Tensor]


def make(cfg: dict, seed: int, device) -> Tuple[Params, Params]:
    """(D leaves, G leaves) by state-dict name, fp32 on ``device``."""
    sides = [cfg["leaves"]["d"], cfg["leaves"]["g"]]
    drawn = [(side, name, spec) for side in sides for name, spec in side.items()
             if not isinstance(spec["init"], str)]
    total = sum(math.prod(spec["shape"]) for _, _, spec in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device, dtype=torch.float32) * 2.0 - 1.0
    out = [{}, {}]
    off = 0
    for side, name, spec in drawn:
        n = math.prod(spec["shape"])
        out[sides.index(side)][name] = (u[off:off + n] * spec["init"]).reshape(spec["shape"])
        off += n
    for i, side in enumerate(sides):
        for name, spec in side.items():
            if spec["init"] == "ones":
                out[i][name] = torch.ones(spec["shape"], device=device)
            elif spec["init"] == "zeros":
                out[i][name] = torch.zeros(spec["shape"], device=device)
        out[i] = {name: out[i][name] for name in side}
    return out[0], out[1]
