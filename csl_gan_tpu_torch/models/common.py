"""Shared building blocks: torch-default Linear init from an explicit
generator, and one_hot.

``init_linear`` draws U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias,
the distribution the JAX package's TorchDense uses (its models/common.py
torch_kernel_init), from a caller-supplied ``torch.Generator`` instead of
torch's global RNG.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_linear(layer: nn.Linear, gen: torch.Generator) -> None:
    bound = 1.0 / (layer.in_features ** 0.5)
    for p in (layer.weight, layer.bias):
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
        p.copy_(u * (2 * bound) - bound)


def one_hot(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    return nn.functional.one_hot(y.long(), n_classes).to(torch.float32)
