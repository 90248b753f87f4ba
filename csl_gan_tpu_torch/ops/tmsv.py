"""Trimmed-mean / sign-vote DP aggregation (the tm/sv engines): the port's
copy of the JAX package's ops/tmsv.py.

Per coordinate, over the per-sample gradients ``g [B, ...]`` of one leaf:

- sign vote: ``(sum_i sign(g_i) + std * N(0, 1)) / B`` with std =
  2 / sqrt(2 rho), rho-zCDP per step (one sample moves the vote by at most 2);
- trimmed mean: the values clipped to [min_val, max_val], sorted, the m
  smallest and m largest dropped (m at most (B - 1) // 2), the rest averaged,
  plus Student-t(3) noise scaled by the t-smooth sensitivity S / sqrt(2 rho).
  S is the bound of the JAX module: with the sorted values padded by m + 1
  copies of min_val below and max_val above,
  S = max_k e^{-t k} (Z[B-m-1+(k+1)] - Z[m-(k+1)]) / (B - 2m), k = 0..m.

The noise is drawn from an explicit ``torch.Generator``, or handed in as a
pre-drawn tensor (``noise``: N(0, 1) for the vote, Student-t(3) for the mean)
so that the same draws give the same values in both packages. torch's
``StudentT`` takes no generator, so ``student_t3`` builds the draw from four
normals, Z / sqrt((N1^2 + N2^2 + N3^2) / 3), which is exact for integer
degrees of freedom.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def sv_noise_std(rho_per_step: float) -> float:
    """Gaussian std of the sign vote: sensitivity 2 over sqrt(2 rho)."""
    return 2.0 / math.sqrt(2.0 * rho_per_step)


def student_t3(gen: torch.Generator, shape) -> torch.Tensor:
    """Student-t draws with 3 degrees of freedom, on the generator's device."""
    n = torch.randn((4,) + tuple(shape), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return n[0] / torch.sqrt((n[1] ** 2 + n[2] ** 2 + n[3] ** 2) / 3.0)


def sign_vote(g: torch.Tensor, rho_per_step: float,
              gen: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noisy per-coordinate sign vote of g [B, ...], divided by B."""
    return noisy_vote(vote_sum(g), g.shape[0], rho_per_step, gen, noise)


def vote_sum(g: torch.Tensor) -> torch.Tensor:
    """The per-coordinate sum of the signs of g [B, ...]: a sum over rows,
    which ranks of a data axis add up."""
    return torch.sum(torch.sign(g), dim=0)


def noisy_vote(vote: torch.Tensor, b: int, rho_per_step: float,
               gen: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(vote + noise) / b of a summed vote over b rows."""
    if noise is None:
        noise = torch.randn(vote.shape, generator=gen, device=gen.device,
                            dtype=torch.float32)
    return (vote + sv_noise_std(rho_per_step) * noise) / b


def trimmed_mean_sensitivity(z: torch.Tensor, m: int, t: float,
                             min_val: float, max_val: float) -> torch.Tensor:
    """t-smooth sensitivity bound of the m-trimmed mean per coordinate; z is
    the sorted (along axis 0), clipped values [B, ...]."""
    b = z.shape[0]
    n_keep = b - 2 * m
    terms = []
    for k in range(m + 1):
        s_k = k + 1                  # distance k plus the local change
        ub, lb = b - m - 1 + s_k, m - s_k
        hi = z.new_full(z.shape[1:], max_val) if ub > b - 1 else z[ub]
        lo = z.new_full(z.shape[1:], min_val) if lb < 0 else z[lb]
        terms.append(math.exp(-t * k) * (hi - lo) / n_keep)
    return torch.amax(torch.stack(terms), dim=0)


def trimmed_mean(g: torch.Tensor, m: int, min_val: float, max_val: float,
                 t: float, rho_per_step: float,
                 gen: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-coordinate m-trimmed mean of g [B, ...] with smooth-sensitivity
    Student-t(3) noise."""
    b = g.shape[0]
    m = min(m, (b - 1) // 2)
    z = torch.sort(torch.clamp(g, min_val, max_val), dim=0).values
    mean = torch.mean(z[m:b - m], dim=0)
    s = trimmed_mean_sensitivity(z, m, t, min_val, max_val)
    if noise is None:
        noise = student_t3(gen, mean.shape)
    return mean + noise * (s / math.sqrt(2.0 * rho_per_step))
