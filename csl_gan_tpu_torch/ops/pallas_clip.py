"""Fused per-sample-weighted gradient sum + Gaussian DP noise (K6).

The port's counterpart of the JAX package's ops/pallas_clip.py: the second
pass of gradient-clipping DP over one leaf of the materialized per-sample
gradients,

    out[p] = sum_b w[b] * g[b, p] + std * N(0, 1)

with g [B, ...] fp32, w [B] the clip factors and std = sigma * C. It runs on
the gc D step's materialized route (``--pallas true`` where neither ghost
route applies) for every leaf of at least ``MIN_PALLAS_ELEMS`` elements, the
JAX package's gate, so both packages send the same leaves to the kernel.
Leaves arrive in torch layout ([B, out, in, kh, kw] for a conv): the sum is
elementwise in p and the noise i.i.d., so a flat view serves and nothing is
transposed or padded.

- ``leaf_weighted_sum_noise`` launches the hand-written CUDA kernel of
  ``csrc/clip_noise.cu`` for CUDA tensors, takes ``weighted_sum_noise_plain``
  for CPU tensors and raises for anything else.
- ``weighted_sum_noise_plain``, ``philox4x32_10`` and ``normal_from_bits`` are
  the same function in plain PyTorch, noise included: the kernel's bits are
  Philox4x32-10 keyed by the seed with the element index as the counter, and
  the plain version computes the same Philox with integer tensor operations
  and the same Box-Muller (the TPU kernel's ``_normal_from_bits``), so kernel
  and plain agree on the noise too, not only at std = 0.

The stream and the privacy argument: a step draws one 63-bit seed per (step,
leaf) from the Trainer's generator, on the device; within a leaf every
element has its own counter. So no two elements of a run share a (key,
counter) pair except by a seed collision (probability ~n^2 / 2^64 over n
draws), Philox blocks of distinct pairs are independent uniform words, and
every coordinate of every step gets its own N(0, std^2) draw: the Gaussian
mechanism the accountant assumes. seed and std are read from device memory;
the step never waits for the host. std = 0 still runs the generator and adds
0 * z, as the TPU kernel does (exactness tests rely on it).

Under a model axis (``--tp``) a rank holds a dim-0 slice of a leaf, the
contiguous flat range [base, base + P) of it: its elements take the
counters base + p (``base``), so the slices' noise is exactly the
one-device draw's, cut.
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch

MIN_PALLAS_ELEMS = 1 << 14  # leaves smaller than this take the small-leaf branch

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo32(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32-bit words of m * x for a 32-bit constant m and 32-bit
    values x held in int64, by 16-bit halves so that no int64 overflows."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = xh * ml + xl * mh
    lo = xl * ml + ((mid & 0xFFFF) << 16)
    hi = xh * mh + (mid >> 16) + (lo >> 32)
    return hi, lo & _MASK32


def philox4x32_10(counter, key) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 (Salmon et al., Random123) on int64 tensors holding
    32-bit words: ``counter`` is four broadcastable tensors, ``key`` two.
    Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def normal_from_bits(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Standard normals by Box-Muller over two 32-bit words (int64 tensors),
    the TPU kernel's transform: 24-bit uniforms u1 = (b1 >> 8) 2^-24 + 2^-25
    in (0, 1] after fp32 rounding, u2 = (b2 >> 8) 2^-24."""
    u1 = (b1 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (b2 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(u2 * (2.0 * math.pi))


def philox_normal(seed: torch.Tensor, n: int, base: int = 0) -> torch.Tensor:
    """The kernel's noise stream: z[p] for base <= p < base + n from the
    64-bit ``seed`` (an int64 scalar tensor), counter (p, 0, 0, 0), words 0
    and 1."""
    seed = seed.reshape(()).to(torch.int64)
    p = torch.arange(base, base + n, dtype=torch.int64, device=seed.device)
    zero = torch.zeros((), dtype=torch.int64, device=seed.device)
    key = (seed & _MASK32, (seed >> 32) & _MASK32)
    w = philox4x32_10((p & _MASK32, p >> 32, zero, zero), key)
    return normal_from_bits(w[0], w[1])


def _as_scalar(v, dtype, device) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.reshape(()).to(device=device, dtype=dtype)
    return torch.tensor(v, dtype=dtype, device=device)


def weighted_sum_noise_plain(g2d: torch.Tensor, w: torch.Tensor, seed,
                             std, base: int = 0) -> torch.Tensor:
    """Plain version of K6 on g2d [B, P]: the fp32 product w @ g2d (on a CUDA
    device the caller keeps TF32 off) plus std times the kernel's stream at
    the counters base .. base + P - 1."""
    acc = w.to(torch.float32) @ g2d.to(torch.float32)
    z = philox_normal(_as_scalar(seed, torch.int64, g2d.device), g2d.shape[1], base)
    return acc + _as_scalar(std, torch.float32, g2d.device) * z


def leaf_weighted_sum_noise(g: torch.Tensor, w: torch.Tensor,
                            seed: Union[int, torch.Tensor],
                            std: Union[float, torch.Tensor], base: int = 0) -> torch.Tensor:
    """One per-sample-grad leaf g [B, ...] -> sum_b w[b] g[b] + std * N(0, 1)
    of shape g.shape[1:]: K6 for CUDA tensors, the plain version for CPU
    tensors. ``seed`` (int64) and ``std`` (fp32) are numbers or scalar tensors;
    on the card they are read from device memory. ``base`` is the counter of
    the first element (a model slice's offset in its leaf). Adds one to
    ``leaf_weighted_sum_noise.launches`` per K6 launch."""
    b, shape = g.shape[0], g.shape[1:]
    p = g[0].numel() if g.dim() > 1 else 1
    if base < 0:
        raise ValueError(f"the counter base must be non-negative, got {base}")
    if g.device.type == "cpu":
        return weighted_sum_noise_plain(g.reshape(b, p), w, seed, std, base).reshape(shape)
    if g.device.type != "cuda":
        raise ValueError(f"leaf_weighted_sum_noise takes CPU or CUDA tensors, got {g.device}")
    if g.dtype != torch.float32 or not g.is_contiguous() or b < 1 or p < 1:
        raise ValueError(f"g must be a contiguous non-empty fp32 tensor, got {g.dtype} "
                         f"{tuple(g.shape)} (contiguous: {g.is_contiguous()})")
    if w.device != g.device or w.dtype != torch.float32 or tuple(w.shape) != (b,):
        raise ValueError(f"w must be an fp32 [{b}] tensor on {g.device}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    from csl_gan_tpu_torch.ops import _build

    w = w.contiguous()
    seed_t = _as_scalar(seed, torch.int64, g.device)
    std_t = _as_scalar(std, torch.float32, g.device)
    lib = _build.load("clip_noise")
    partial = torch.empty(lib.clip_noise_scratch(b, p), dtype=torch.float32, device=g.device)
    out = torch.empty(shape, dtype=torch.float32, device=g.device)
    rc = lib.clip_noise(g.data_ptr(), w.data_ptr(), seed_t.data_ptr(), std_t.data_ptr(),
                        b, p, int(base), partial.data_ptr(), out.data_ptr(),
                        torch.cuda.current_stream(g.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"clip_noise failed: {lib.cn_error_string(rc).decode()}")
    leaf_weighted_sum_noise.launches += 1
    return out


leaf_weighted_sum_noise.launches = 0
