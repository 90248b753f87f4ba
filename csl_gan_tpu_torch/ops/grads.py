"""Clip factors, clip statistics and Gaussian DP noise (the parts of the JAX
package's ops/grads.py that the MNIST gc path uses).

Leaves are lists of tensors in the JAX package's leaf order
(models/mnist.py D_LEAVES); per-leaf vectors such as the clip statistics
follow the same order.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Union

import torch


class ClipStats(NamedTuple):
    """Per-leaf per-sample-norm statistics for logging (train.py:310-329)."""
    norm_mean: torch.Tensor     # [n_leaves]
    norm_std: torch.Tensor      # [n_leaves] (population std)
    norm_max: torch.Tensor      # [n_leaves]
    frac_clipped: torch.Tensor  # [n_leaves] share of samples with factor < 0.999


def clip_factors(leaf_norms: torch.Tensor,
                 max_norm: Union[float, Sequence[float]],
                 per_layer: bool) -> torch.Tensor:
    """Clipping factors per (leaf, sample), shape [n_leaves, batch]: one
    flat norm per sample (flat mode) or one threshold per leaf."""
    if per_layer:
        thr = torch.as_tensor(max_norm, dtype=torch.float32,
                              device=leaf_norms.device)[:, None]
        return torch.clamp(thr / (leaf_norms + 1e-12), max=1.0)
    flat = torch.sqrt(torch.sum(leaf_norms ** 2, dim=0, keepdim=True))
    factor = torch.clamp(float(max_norm) / (flat + 1e-12), max=1.0)
    return factor.expand(leaf_norms.shape)


def stats_from_norms(leaf_norms: torch.Tensor, factors: torch.Tensor) -> ClipStats:
    return ClipStats(
        norm_mean=leaf_norms.mean(dim=1),
        norm_std=leaf_norms.std(dim=1, correction=0),
        norm_max=leaf_norms.amax(dim=1),
        frac_clipped=(factors < 0.999).to(torch.float32).mean(dim=1),
    )


def noise_std(sigma: float, max_norm: float) -> float:
    """sigma * C rounded as the JAX package computes it (fp32 product)."""
    return float(torch.tensor(max_norm, dtype=torch.float32)
                 * torch.tensor(sigma, dtype=torch.float32))


def noise_like(gen: torch.Generator, leaves: Sequence[torch.Tensor],
               std: float, lead: tuple = ()) -> List[torch.Tensor]:
    """std * N(0, 1) for each leaf shape, with optional leading dims
    (a [steps, ...] draw for a whole epoch). Drawn on the generator's
    device."""
    return [torch.randn(lead + tuple(l.shape), generator=gen,
                        device=gen.device, dtype=torch.float32) * std
            for l in leaves]


def add_gaussian_noise(gen: torch.Generator, leaves: Sequence[torch.Tensor],
                       sigma: float, max_norm: float) -> List[torch.Tensor]:
    """Add N(0, (sigma*C)^2) per parameter (flat clipping; the Opacus
    noise-at-step semantics, JAX ops/grads.py:289)."""
    std = noise_std(sigma, max_norm)
    return [l + n for l, n in zip(leaves, noise_like(gen, leaves, std))]
