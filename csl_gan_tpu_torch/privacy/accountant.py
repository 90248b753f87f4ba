"""Stateful RDP accountant (the port's copy of the JAX package's).

Tracks RDP over homogeneous sampled-Gaussian steps with the accounting inputs
of the reference engines (train.py:96-101): sample_rate = batch_size /
sample_size, noise_multiplier = sigma, orders = alphas.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from csl_gan_tpu_torch.privacy import rdp as rdp_mod


@dataclass
class RdpAccountant:
    batch_size: int
    sample_size: int
    noise_multiplier: float
    alphas: List[float] = field(default_factory=lambda: list(rdp_mod.DEFAULT_ALPHAS))
    steps: float = 0.0

    @property
    def sample_rate(self) -> float:
        return self.batch_size / self.sample_size

    def step(self, n: int = 1) -> None:
        self.steps += n

    def get_privacy_spent(self, delta: float) -> Tuple[float, float]:
        """(epsilon, best_alpha) after `self.steps` compositions."""
        if self.steps == 0:
            return 0.0, float(self.alphas[0])
        # RDP composes linearly in steps: cache the one-step values.
        cached = getattr(self, "_rdp_one_step", None)
        if cached is None:
            cached = rdp_mod.compute_rdp(self.sample_rate,
                                         self.noise_multiplier, 1, self.alphas)
            object.__setattr__(self, "_rdp_one_step", cached)
        return rdp_mod.get_privacy_spent(self.alphas, cached * self.steps, delta)


def make_accountant(opt) -> RdpAccountant:
    """The accountant for a gc-mode config (budget_analysis.py:24-33)."""
    return RdpAccountant(batch_size=opt.batch_size, sample_size=opt.train_set_size,
                         noise_multiplier=opt.sigma)
