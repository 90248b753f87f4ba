"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC 2011) and the Box-Muller normals a configuration states for its
counter-based DP noise, in plain integer tensor arithmetic.

Element p of a leaf takes the counter (p, 0, 0, 0) under the 64-bit key of
its seed; words 0 and 1 of the block give the uniforms u1 = (w0 >> 8) 2^-24
+ 2^-25 and u2 = (w1 >> 8) 2^-24, and z = sqrt(-2 ln u1) cos(2 pi u2).
"""

from __future__ import annotations

import math

import torch

M32 = (1 << 32) - 1
MUL = (0xD2511F53, 0xCD9E8D57)
WEYL = (0x9E3779B9, 0xBB67AE85)


def _mul_hi_lo(m: int, x: torch.Tensor):
    """High and low 32-bit words of m * x (x < 2^32 in int64), by 16-bit
    limbs so that nothing overflows 63 bits."""
    a_hi, a_lo = m >> 16, m & 0xFFFF
    x_hi, x_lo = x >> 16, x & 0xFFFF
    lo_lo = a_lo * x_lo
    cross = a_hi * x_lo + a_lo * x_hi
    low = lo_lo + ((cross & 0xFFFF) << 16)
    high = a_hi * x_hi + (cross >> 16) + (low >> 32)
    return high & M32, low & M32


def block(counter, key):
    """The four output words of Philox4x32-10."""
    x0, x1, x2, x3 = counter
    k0, k1 = key
    for _ in range(10):
        h0, l0 = _mul_hi_lo(MUL[0], x0)
        h1, l1 = _mul_hi_lo(MUL[1], x2)
        x0, x1, x2, x3 = (h1 ^ x1 ^ k0) & M32, l1, (h0 ^ x3 ^ k1) & M32, l0
        k0, k1 = (k0 + WEYL[0]) & M32, (k1 + WEYL[1]) & M32
    return x0, x1, x2, x3


def normals(seed: int, n: int, device) -> torch.Tensor:
    """z[p], p = 0 .. n - 1, of one leaf keyed by the 64-bit ``seed``."""
    p = torch.arange(n, dtype=torch.int64, device=device)
    zero = torch.zeros((), dtype=torch.int64, device=device)
    seed = int(seed) & ((1 << 64) - 1)
    key = (torch.tensor(seed & M32, device=device), torch.tensor(seed >> 32, device=device))
    w0, w1, _, _ = block((p & M32, p >> 32, zero, zero), key)
    u1 = (w0 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (w1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(u2 * (2.0 * math.pi))
