"""Plain RDP accounting of the sampled Gaussian mechanism (Mironov, Talwar
and Zhang, "Renyi differential privacy of the sampled Gaussian mechanism",
2019) and its classic conversion to (epsilon, delta): epsilon =
min over alpha of steps * RDP(alpha) - ln(delta) / (alpha - 1)."""

from __future__ import annotations

import math
from typing import Sequence


def _log_add(a: float, b: float) -> float:
    hi, lo = max(a, b), min(a, b)
    if hi == -math.inf:
        return hi
    return hi + math.log1p(math.exp(lo - hi))


def _log_sub(a: float, b: float) -> float:
    if b == -math.inf:
        return a
    if a == b:
        return -math.inf
    return a + math.log1p(-math.exp(b - a))


def _log_erfc(x: float) -> float:
    if x < 20.0:
        return math.log(math.erfc(x))
    # erfc(x) ~ exp(-x^2) / (x sqrt(pi)) (1 - 1/(2x^2) + 3/(4x^4) - ...)
    return (-x * x - math.log(x) - 0.5 * math.log(math.pi)
            + math.log1p(-0.5 / x ** 2 + 0.75 / x ** 4 - 1.875 / x ** 6))


def _log_a_int(q: float, sigma: float, alpha: int) -> float:
    out = -math.inf
    for i in range(alpha + 1):
        log_coef = math.lgamma(alpha + 1) - math.lgamma(i + 1) - math.lgamma(alpha - i + 1)
        out = _log_add(out, log_coef + i * math.log(q) + (alpha - i) * math.log(1 - q)
                       + (i * i - i) / (2 * sigma ** 2))
    return out


def _log_a_frac(q: float, sigma: float, alpha: float) -> float:
    a0 = a1 = -math.inf
    z0 = sigma ** 2 * math.log(1 / q - 1) + 0.5
    coef, i = 1.0, 0
    while True:
        j = alpha - i
        log_coef = math.log(abs(coef))
        t0 = log_coef + i * math.log(q) + j * math.log(1 - q)
        t1 = log_coef + j * math.log(q) + i * math.log(1 - q)
        e0 = math.log(0.5) + _log_erfc((i - z0) / (math.sqrt(2) * sigma))
        e1 = math.log(0.5) + _log_erfc((z0 - j) / (math.sqrt(2) * sigma))
        s0 = t0 + (i * i - i) / (2 * sigma ** 2) + e0
        s1 = t1 + (j * j - j) / (2 * sigma ** 2) + e1
        if coef > 0:
            a0, a1 = _log_add(a0, s0), _log_add(a1, s1)
        else:
            a0, a1 = _log_sub(a0, s0), _log_sub(a1, s1)
        i += 1
        coef *= (alpha - i + 1) / i
        if max(s0, s1) < -30:
            return _log_add(a0, a1)


def rdp(q: float, sigma: float, alpha: float) -> float:
    """RDP of one step at order alpha."""
    if q == 0:
        return 0.0
    if q == 1.0:
        return alpha / (2 * sigma ** 2)
    if float(alpha).is_integer():
        return _log_a_int(q, sigma, int(alpha)) / (alpha - 1)
    return _log_a_frac(q, sigma, alpha) / (alpha - 1)


def orders(spec: dict) -> list:
    """The orders a configuration states: 1 + k / 10 for k in [1, 99], then
    the integers in [first_integer, last_integer]."""
    return ([1 + k / 10.0 for k in range(1, spec["tenths_up_to"] + 1)]
            + list(range(spec["first_integer"], spec["last_integer"] + 1)))


def epsilon(q: float, sigma: float, steps: float, delta: float,
            alphas: Sequence[float]) -> float:
    if steps == 0:
        return 0.0
    return min(steps * rdp(q, sigma, a) - math.log(delta) / (a - 1) for a in alphas)
