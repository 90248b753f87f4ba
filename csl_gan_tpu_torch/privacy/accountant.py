"""Stateful privacy accountants (the port's copies of the JAX package's
privacy/accountant.py).

``RdpAccountant`` tracks RDP over homogeneous sampled-Gaussian steps with
the accounting inputs of the reference engines (train.py:96-101):
sample_rate = batch_size / sample_size, noise_multiplier = sigma, orders =
alphas. ``ZcdpAccountant`` is the tm/sv engines' zCDP ledger, which
``budget_analysis`` reads from their ``opt.txt``. Both save to and load from
the dict the D checkpoint carries, in the JAX package's layout, so epsilon
continues across a resume in either package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import math
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

    def state_dict(self) -> dict:
        return {
            "kind": "rdp",
            "batch_size": self.batch_size,
            "sample_size": self.sample_size,
            "noise_multiplier": self.noise_multiplier,
            "alphas": list(self.alphas),
            "steps": self.steps,
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "RdpAccountant":
        return cls(**{k: v for k, v in state.items() if k != "kind"})


@dataclass
class ZcdpAccountant:
    """zCDP accounting for the tm/sv engines' per-epoch rho budget
    (reference train.py:126,132 ``rho_per_epoch``): total rho = steps *
    rho_per_step, converted via eps = rho + 2*sqrt(rho*ln(1/delta))."""

    rho_per_step: float
    steps: float = 0.0

    def step(self, n: int = 1) -> None:
        self.steps += n

    def get_privacy_spent(self, delta: float) -> Tuple[float, float]:
        """(epsilon, rho spent)."""
        rho = self.rho_per_step * self.steps
        if rho == 0:
            return 0.0, 0.0
        return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta)), rho

    def state_dict(self) -> dict:
        return {"kind": "zcdp", "rho_per_step": self.rho_per_step, "steps": self.steps}

    @classmethod
    def from_state_dict(cls, state: dict) -> "ZcdpAccountant":
        return cls(rho_per_step=state["rho_per_step"], steps=state["steps"])


def accountant_from_state_dict(state: dict):
    if state.get("kind") == "zcdp":
        return ZcdpAccountant.from_state_dict(state)
    return RdpAccountant.from_state_dict(state)


def make_accountant(opt):
    """The accountant for a config (budget_analysis.py:24-33): zCDP at
    ``tm_rho_per_epoch`` per epoch for tm / sv, RDP of the sampled Gaussian
    otherwise."""
    if opt.dp_mode in ("tm", "sv"):
        steps_per_epoch = max(1, opt.train_set_size // opt.batch_size)
        return ZcdpAccountant(rho_per_step=opt.tm_rho_per_epoch / steps_per_epoch)
    return RdpAccountant(batch_size=opt.batch_size, sample_size=opt.train_set_size,
                         noise_multiplier=opt.sigma)
