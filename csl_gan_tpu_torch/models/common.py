"""Shared building blocks: torch-default Linear / Conv2d init from an explicit
generator, one_hot, nearest 2x upsampling.

``torch_kernel_init`` draws U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight
and bias, the distribution the JAX package's TorchDense / TorchConv use (its
models/common.py torch_kernel_init), from a caller-supplied
``torch.Generator`` instead of torch's global RNG.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def torch_kernel_init(layer: nn.Module, gen: torch.Generator) -> None:
    """U(+-1/sqrt(fan_in)) for the weight and bias of a Linear or Conv2d, with
    fan_in = in_features or in_channels * kh * kw."""
    fan_in = layer.weight[0].numel()
    bound = 1.0 / (fan_in ** 0.5)
    for p in (layer.weight, layer.bias):
        if p is None:
            continue
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
        p.copy_(u * (2 * bound) - bound)


def one_hot(y: torch.Tensor, n_classes: int) -> torch.Tensor:
    """fp32 one-hot rows of integer labels, as a comparison against the class
    range: ``nn.functional.one_hot`` checks its input's range on the host,
    which ``torch.func.vmap`` (the per-sample-gradient route) cannot batch."""
    classes = torch.arange(n_classes, device=y.device)
    return (y.long()[..., None] == classes).to(torch.float32)


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x spatial upsample of NHWC x (the JAX package's
    models/common.py upsample_nearest_2x)."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)
