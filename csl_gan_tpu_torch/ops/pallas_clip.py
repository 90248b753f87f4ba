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

- ``leaves_weighted_sum_noise`` takes a step's large leaves (the same B)
  and, for CUDA tensors, launches the hand-written CUDA kernel of
  ``csrc/clip_noise.cu`` once over all of them (``group_plan`` gives the
  launch's tiles, cluster and rows, once a shape); for CPU tensors it loops
  ``weighted_sum_noise_plain`` over the leaves; anything else raises.
  ``leaf_weighted_sum_noise`` is its one-leaf call.
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

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

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


def _on_device(v, dtype, device) -> torch.Tensor:
    """A seed or std, or a step's seeds or stds, as a contiguous tensor of
    ``dtype`` on ``device``; a tensor that already is one passes as it is."""
    if isinstance(v, torch.Tensor) and v.dtype == dtype and v.device == device \
            and v.is_contiguous():
        return v
    return torch.as_tensor(v).to(device=device, dtype=dtype).contiguous()


def weighted_sum_noise_plain(g2d: torch.Tensor, w: torch.Tensor, seed,
                             std, base: int = 0) -> torch.Tensor:
    """Plain version of K6 on g2d [B, P]: the fp32 product w @ g2d (on a CUDA
    device the caller keeps TF32 off) plus std times the kernel's stream at
    the counters base .. base + P - 1."""
    acc = w.to(torch.float32) @ g2d.to(torch.float32)
    z = philox_normal(_on_device(seed, torch.int64, g2d.device), g2d.shape[1], base)
    return acc + _on_device(std, torch.float32, g2d.device).reshape(()) * z


MAX_LEAVES = 16        # leaves one launch takes (the kernel's table)
_TILES = (1024, 512, 256)     # tile widths in columns, four a thread
_MAX_CLUSTER = 8              # the portable cluster size
_CTAS_PER_SM = 3              # CTAs a launch wants an SM, at the least


class GroupPlan(NamedTuple):
    """One launch's geometry: ``tile`` columns a work item, a cluster of
    ``cluster`` CTAs a tile with ``rows`` rows of B each, each leaf's first
    work item ``tile0`` (a prefix sum of the leaves' tile counts) and load
    width ``vec`` (4: 16-byte loads; 1: guarded scalar loads)."""
    tile: int
    cluster: int
    rows: int
    tile0: Tuple[int, ...]
    vec: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def group_plan(B: int, Ps: Tuple[int, ...], aligned: Tuple[bool, ...], n_sm: int) -> GroupPlan:
    """The plan of one launch over leaves [B, P] (``Ps``), computed once a
    shape. A CTA that streams more rows pays its start and its cluster
    barrier over more bytes, so: the widest tile whose tiles alone give
    ``_CTAS_PER_SM`` CTAs an SM, each CTA taking every row; else the
    narrowest tile, with B cut over the smallest cluster (at most 8) that
    gives them. A leaf loads 16 bytes at a time where ``P % 4 == 0`` and its
    pointers are ``aligned``."""
    target = _CTAS_PER_SM * n_sm
    for tile in _TILES:
        tiles = [-(-p // tile) for p in Ps]
        if sum(tiles) >= target:
            break
    c = min(_MAX_CLUSTER, B, -(-target // sum(tiles)))
    rows = -(-B // c)
    tile0 = tuple(sum(tiles[:i]) for i in range(len(Ps)))
    vec = tuple(4 if p % 4 == 0 and a else 1 for p, a in zip(Ps, aligned))
    return GroupPlan(tile, -(-B // rows), rows, tile0, vec)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    """The SMs of CUDA device ``index``, read once."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def leaves_weighted_sum_noise_plain(gs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                                    seeds, stds, bases: Optional[Sequence[int]] = None,
                                    slots: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """The plain version of ``leaves_weighted_sum_noise``: leaf by leaf,
    ``weighted_sum_noise_plain`` at the leaf's seed, std and counter base."""
    n = len(gs)
    bases = [0] * n if bases is None else bases
    slots = range(n) if slots is None else slots
    seeds = _on_device(seeds, torch.int64, gs[0].device).reshape(-1)
    stds = _on_device(stds, torch.float32, gs[0].device).reshape(-1)
    return [weighted_sum_noise_plain(g.reshape(g.shape[0], -1), w, seeds[s], stds[s],
                                     base).reshape(g.shape[1:])
            for g, w, base, s in zip(gs, ws, bases, slots)]


def leaves_weighted_sum_noise(gs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor],
                              seeds, stds, bases: Optional[Sequence[int]] = None,
                              slots: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """K6 over a group of per-sample-grad leaves g_l [B, ...] (the same B)
    with weights w_l [B]: [sum_b w_l[b] g_l[b] + stds[s_l] * N(0, 1)] of shape
    g_l.shape[1:], from one CUDA launch for CUDA tensors, the plain version
    leaf by leaf for CPU tensors. ``seeds`` (int64) and ``stds`` (fp32) are
    the step's tensors (or numbers); leaf l reads slot ``slots[l]`` (default
    l) of both, on the card from device memory. ``bases[l]`` is the counter
    of the leaf's first element (a model slice's offset in its leaf; default
    0). Adds one to ``leaves_weighted_sum_noise.launches`` per launch and the
    group's size to ``.leaves``."""
    n = len(gs)
    bases = [0] * n if bases is None else [int(v) for v in bases]
    slots = list(range(n)) if slots is None else [int(v) for v in slots]
    if not 1 <= n <= MAX_LEAVES:
        raise ValueError(f"K6 takes 1 to {MAX_LEAVES} leaves a launch, got {n}")
    if not len(ws) == len(bases) == len(slots) == n:
        raise ValueError(f"{n} leaves need {n} weights, bases and slots, got {len(ws)}, "
                         f"{len(bases)}, {len(slots)}")
    dev = gs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"leaves_weighted_sum_noise takes CPU or CUDA tensors, got {dev}")
    b = gs[0].shape[0] if gs[0].dim() else 0
    for g, w, base, slot in zip(gs, ws, bases, slots):
        if g.device != dev or w.device != dev:
            raise ValueError(f"every leaf and weight must be on {dev}, got {g.device} and "
                             f"{w.device}")
        if g.dtype != torch.float32 or not g.is_contiguous() or g.dim() < 1 \
                or g.shape[0] != b or b < 1 or g.numel() == 0:
            raise ValueError(f"each g must be a contiguous non-empty fp32 [{b}, ...] tensor, "
                             f"got {g.dtype} {tuple(g.shape)} (contiguous: "
                             f"{g.is_contiguous()})")
        if w.dtype != torch.float32 or tuple(w.shape) != (b,) or not w.is_contiguous():
            raise ValueError(f"each w must be a contiguous fp32 [{b}] tensor, got {w.dtype} "
                             f"{tuple(w.shape)}")
        if base < 0 or slot < 0:
            raise ValueError(f"the counter base and slot must be non-negative, got {base}, "
                             f"{slot}")
    if dev.type == "cpu":
        return leaves_weighted_sum_noise_plain(gs, ws, seeds, stds, bases, slots)
    from csl_gan_tpu_torch.ops import _build

    seeds, stds = _on_device(seeds, torch.int64, dev), _on_device(stds, torch.float32, dev)
    if max(slots) >= min(seeds.numel(), stds.numel()):
        raise ValueError(f"slot {max(slots)} past the {seeds.numel()} seeds / {stds.numel()} "
                         f"stds")
    outs = [g.new_empty(g.shape[1:]) for g in gs]
    ps = tuple(g.numel() // b for g in gs)
    aligned = tuple(g.data_ptr() % 16 == 0 and o.data_ptr() % 16 == 0 for g, o in zip(gs, outs))
    plan = group_plan(b, ps, aligned, _n_sm(dev.index))
    desc = []
    for i, (g, w, o) in enumerate(zip(gs, ws, outs)):
        desc += (g.data_ptr(), w.data_ptr(), o.data_ptr(), ps[i], bases[i], slots[i],
                 plan.tile0[i], plan.vec[i])
    lib = _build.load("clip_noise")
    rc = lib.clip_noise_leaves((ctypes.c_longlong * len(desc))(*desc), n, b, plan.tile,
                               plan.cluster, plan.rows, seeds.data_ptr(), stds.data_ptr(),
                               torch._C._cuda_getCurrentRawStream(dev.index))
    if rc != 0:
        raise RuntimeError(f"clip_noise failed: {lib.cn_error_string(rc).decode()}")
    leaves_weighted_sum_noise.launches += 1
    leaves_weighted_sum_noise.leaves += n
    return outs


leaves_weighted_sum_noise.launches = 0
leaves_weighted_sum_noise.leaves = 0


def leaf_weighted_sum_noise(g: torch.Tensor, w: torch.Tensor,
                            seed: Union[int, torch.Tensor],
                            std: Union[float, torch.Tensor], base: int = 0) -> torch.Tensor:
    """One per-sample-grad leaf g [B, ...] -> sum_b w[b] g[b] + std * N(0, 1)
    of shape g.shape[1:]: a one-leaf ``leaves_weighted_sum_noise``. ``seed``
    (int64) and ``std`` (fp32) are numbers or scalar tensors; on the card
    they are read from device memory. ``base`` is the counter of the first
    element (a model slice's offset in its leaf)."""
    return leaves_weighted_sum_noise([g], [w], seed, std, [base])[0]
