"""Renyi differential privacy accounting for the sampled Gaussian mechanism.

Pure-NumPy implementation of the RDP bound of Mironov, Talwar & Zhang,
"Renyi Differential Privacy of the Sampled Gaussian Mechanism" (2019),
providing the same public surface the reference exercises through its Opacus
fork (`opacus.privacy_analysis.compute_rdp` / `get_privacy_spent`; used at
reference mean_sampler.py:5,91-92 and indirectly by train.py:295 /
budget_analysis.py:80).

The accountant is model-free: epsilon depends only on
(sample_rate q, noise multiplier sigma, number of steps, RDP orders) —
reference budget_analysis.py exploits exactly this by rebuilding the engine on
a dummy one-parameter model (budget_analysis.py:24-33).

Orders grid of training/accounting: [1.1..10.9 step .1] + [12..399]
(reference train.py:99).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple, Union

import numpy as np
from scipy import special

DEFAULT_ALPHAS: List[float] = [1 + x / 10.0 for x in range(1, 100)] + list(range(12, 400))
# budget_analysis's wider grid (reference budget_analysis.py:39).
BUDGET_TOOL_ALPHAS: List[float] = [1 + x / 10.0 for x in range(1, 100)] + list(range(12, 1200))


def _log_add(logx: float, logy: float) -> float:
    """log(exp(logx) + exp(logy)) computed stably."""
    a, b = min(logx, logy), max(logx, logy)
    if a == -np.inf:
        return b
    return math.log1p(math.exp(a - b)) + b


def _log_sub(logx: float, logy: float) -> float:
    """log(exp(logx) - exp(logy)), requires logx >= logy."""
    if logx < logy:
        raise ValueError("log subtraction of a larger value from a smaller one")
    if logy == -np.inf:
        return logx
    if logx == logy:
        return -np.inf
    try:
        return math.log(math.expm1(logx - logy)) + logy
    except OverflowError:
        return logx


def _log_erfc(x: float) -> float:
    """log(erfc(x)) via the stable normal log-CDF: erfc(x) = 2*ndtr(-sqrt(2)*x)."""
    return math.log(2.0) + special.log_ndtr(-x * 2 ** 0.5)


def _log_comb(n: float, k: int) -> float:
    """log of the (generalized) binomial coefficient binom(n, k) for n >= k."""
    return (special.gammaln(n + 1) - special.gammaln(k + 1) - special.gammaln(n - k + 1))


def _compute_log_a_int(q: float, sigma: float, alpha: int) -> float:
    """log(A_alpha) for integer alpha via the binomial expansion.

    A_alpha = sum_{i=0}^{alpha} C(alpha,i) (1-q)^{alpha-i} q^i exp((i^2-i)/(2 sigma^2))
    """
    log_a = -np.inf
    for i in range(alpha + 1):
        log_coef_i = (_log_comb(alpha, i)
                      + i * math.log(q)
                      + (alpha - i) * math.log1p(-q))
        s = log_coef_i + (i * i - i) / (2 * sigma ** 2)
        log_a = _log_add(log_a, s)
    return float(log_a)


def _compute_log_a_frac(q: float, sigma: float, alpha: float) -> float:
    """log(A_alpha) for fractional alpha via the two-series erfc expansion
    (Mironov et al. 2019, Theorem 3.1 proof)."""
    log_a0, log_a1 = -np.inf, -np.inf
    i = 0
    z0 = sigma ** 2 * math.log(1 / q - 1) + 0.5

    while True:
        coef = special.binom(alpha, i)
        log_coef = math.log(abs(coef)) if coef != 0 else -np.inf
        j = alpha - i

        log_t0 = log_coef + i * math.log(q) + j * math.log1p(-q)
        log_t1 = log_coef + j * math.log(q) + i * math.log1p(-q)

        log_e0 = math.log(0.5) + _log_erfc((i - z0) / (math.sqrt(2) * sigma))
        log_e1 = math.log(0.5) + _log_erfc((z0 - j) / (math.sqrt(2) * sigma))

        log_s0 = log_t0 + (i * i - i) / (2 * sigma ** 2) + log_e0
        log_s1 = log_t1 + (j * j - j) / (2 * sigma ** 2) + log_e1

        if coef > 0:
            log_a0 = _log_add(log_a0, log_s0)
            log_a1 = _log_add(log_a1, log_s1)
        else:
            log_a0 = _log_sub(log_a0, log_s0)
            log_a1 = _log_sub(log_a1, log_s1)

        i += 1
        if max(log_s0, log_s1) < -30:
            break

    return float(_log_add(log_a0, log_a1))


def _compute_rdp_order(q: float, sigma: float, alpha: float) -> float:
    """RDP of one step of the sampled Gaussian mechanism at a single order."""
    if q == 0:
        return 0.0
    if sigma == 0:
        return np.inf
    if q > 1.0:
        raise ValueError(
            f"sampling rate q={q} > 1 (batch_size exceeds sample_size); "
            "the sampled-Gaussian RDP bound is undefined. Fix the config "
            "(options.py rejects batch_size > train_set_size at parse time).")
    if q == 1.0:
        return alpha / (2 * sigma ** 2)
    if np.isinf(alpha):
        return np.inf
    if float(alpha).is_integer():
        log_a = _compute_log_a_int(q, sigma, int(alpha))
    else:
        log_a = _compute_log_a_frac(q, sigma, alpha)
    return log_a / (alpha - 1)


def compute_rdp(q: float, noise_multiplier: float, steps: Union[int, float],
                orders: Union[float, Sequence[float]]) -> np.ndarray:
    """RDP of `steps` compositions of the sampled Gaussian mechanism.

    Args:
      q: subsampling rate (batch_size / sample_size).
      noise_multiplier: sigma (noise std / l2 sensitivity).
      steps: number of compositions (float allowed for parity with the
        reference's `steps = N*epochs/bs`, budget_analysis.py:79).
      orders: one RDP order or an iterable of orders.

    Returns:
      np.ndarray of per-order RDP values (scalar array if one order given).
    """
    if np.isscalar(orders):
        rdp = np.array(_compute_rdp_order(q, noise_multiplier, float(orders)))
    else:
        rdp = np.array([_compute_rdp_order(q, noise_multiplier, float(a)) for a in orders])
    return rdp * steps


def get_privacy_spent(orders: Union[float, Sequence[float]],
                      rdp: Union[float, Sequence[float]],
                      delta: float) -> Tuple[float, float]:
    """Convert RDP to (epsilon, best_alpha) at a target delta.

    Uses the classic conversion eps = rdp - log(delta)/(alpha - 1) over all
    orders and returns the minimizing pair, matching the Opacus-0.x behavior
    the reference relies on (train.py:295, mean_sampler.py:92).
    """
    orders_vec = np.atleast_1d(np.asarray(orders, dtype=float))
    rdp_vec = np.atleast_1d(np.asarray(rdp, dtype=float))
    if len(orders_vec) != len(rdp_vec):
        raise ValueError("orders and rdp must have the same length")

    eps = rdp_vec - math.log(delta) / (orders_vec - 1)
    idx_opt = int(np.nanargmin(eps))
    return float(eps[idx_opt]), float(orders_vec[idx_opt])
