"""Per-sample gradient computation, clipping and noising: the port of the JAX
package's ops/grads.py.

  - ``per_sample_grads``: materialized per-sample gradients,
    ``vmap(grad(per_sample_loss))`` over a functional model call, optionally
    in chunks of the batch.
  - ``clipped_grad_sum``: per-sample L2 norms (flat or per leaf), clip factors
    min(1, C / norm) and the weighted sum; the clipped per-sample gradients
    are never formed, only a [batch] weight vector contracts against each
    leaf. With ``fused_noise`` the sum of every large leaf and its DP noise
    come from one K6 launch (ops/pallas_clip.py).
  - ``two_pass_clipped_grad_sum``: a norms-only pass, then one ordinary
    backward of sum_i w_i * loss_i.
  - ``add_gaussian_noise``: std sigma * C (flat) or sigma * C_l per leaf, which
    keeps the effective noise multiplier exactly sigma in both modes.

Params are dicts of torch state-dict names; per-sample gradients are dicts of
the same names with a leading [batch] axis. Per-leaf vectors (norms, factors,
clip statistics, thresholds, noise stds) follow the order of the params dict
given, which the callers keep in the JAX package's leaf order
(``StepBuilder.d_leaves``).
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch
from torch.func import grad, vmap

from csl_gan_tpu_torch.ops import pallas_clip

Params = Dict[str, torch.Tensor]
MaxNorm = Union[float, Sequence[float]]

# One flat normal draw for the small leaves only up to this many elements
# (the JAX package's ops/grads.py:286); past it, one draw per leaf.
_FLAT_DRAW_MAX = 1 << 18


class ClipStats(NamedTuple):
    """Per-leaf per-sample-norm statistics for logging (train.py:310-329)."""
    norm_mean: torch.Tensor     # [n_leaves]
    norm_std: torch.Tensor      # [n_leaves] (population std)
    norm_max: torch.Tensor      # [n_leaves]
    frac_clipped: torch.Tensor  # [n_leaves] share of samples with factor < 0.999


class FusedNoise(NamedTuple):
    """The fused route's randomness for one step, pre-drawn on the device:
    one int64 seed per leaf (K6 reads those of the large leaves) and N(0, 1)
    draws for the leaves below ``pallas_clip.MIN_PALLAS_ELEMS`` (None for the
    large ones), plus the per-leaf noise stds as an fp32 tensor."""
    seeds: torch.Tensor                      # [n_leaves] int64
    eps: List[Optional[torch.Tensor]]        # per leaf: leaf-shaped or None
    stds: torch.Tensor                       # [n_leaves] fp32


def leaf_norms(grads_ps: Params) -> torch.Tensor:
    """Per-sample L2 norm of each leaf: [n_leaves, batch]."""
    return torch.stack([torch.sqrt(torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1))
                        for g in grads_ps.values()])


def clip_factors(leaf_norms: torch.Tensor, max_norm: MaxNorm,
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


def weighted_sum(grads_ps: Params, factors: torch.Tensor) -> Params:
    """sum_i factors[l, i] * grads_ps[l][i] as one fp32 product per leaf; the
    clipped per-sample gradients are not formed."""
    return {k: (factors[i] @ g.reshape(g.shape[0], -1)).reshape(g.shape[1:])
            for i, (k, g) in enumerate(grads_ps.items())}


def stats_from_norms(leaf_norms: torch.Tensor, factors: torch.Tensor) -> ClipStats:
    return ClipStats(
        norm_mean=leaf_norms.mean(dim=1),
        norm_std=leaf_norms.std(dim=1, correction=0),
        norm_max=leaf_norms.amax(dim=1),
        frac_clipped=(factors < 0.999).to(torch.float32).mean(dim=1),
    )


def _pad_rows(b: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Zero-pad the leading (batch) axis to n_pad rows."""
    extra = n_pad - b.shape[0]
    if extra == 0:
        return b
    return torch.cat([b, b.new_zeros((extra,) + tuple(b.shape[1:]))], dim=0)


def _chunks(batch: Sequence[torch.Tensor], chunk: int):
    """The batch zero-padded to a multiple of ``chunk`` and cut into chunks:
    yields (row mask [chunk] fp32, chunk of every batch tensor)."""
    n = batch[0].shape[0]
    n_pad = -(-n // chunk) * chunk
    padded = [_pad_rows(b, n_pad) for b in batch]
    rows = (torch.arange(n_pad, device=batch[0].device) < n).to(torch.float32)
    for lo in range(0, n_pad, chunk):
        yield rows[lo:lo + chunk], tuple(b[lo:lo + chunk] for b in padded)


def per_sample_grads(loss_fn: Callable, params: Params, *batch: torch.Tensor,
                     chunk: Optional[int] = None) -> Params:
    """Materialized per-sample grads: the params dict with a leading [batch]
    axis. ``loss_fn(params, *example)`` returns the scalar loss of one sample.
    Batches that do not divide by ``chunk`` are zero-padded to the next
    multiple; the pad rows' gradients are dropped."""
    gfn = vmap(grad(loss_fn), in_dims=(None,) + (0,) * len(batch))
    if chunk is None:
        return gfn(params, *batch)
    n = batch[0].shape[0]
    parts = [gfn(params, *bc) for _, bc in _chunks(batch, chunk)]
    return {k: torch.cat([p[k] for p in parts], dim=0)[:n] for k in params}


def noise_stds(n_leaves: int, sigma: float, max_norm: MaxNorm,
               per_layer: bool) -> List[float]:
    """Per-leaf DP noise std: sigma * C (flat) or sigma * C_l (per leaf),
    rounded as the JAX package computes them (an fp32 product)."""
    c = torch.as_tensor(max_norm, dtype=torch.float32)
    stds = c * torch.tensor(sigma, dtype=torch.float32)
    return stds.tolist() if per_layer else [float(stds)] * n_leaves


def noise_std(sigma: float, max_norm: float) -> float:
    """sigma * C of flat clipping (see ``noise_stds``)."""
    return noise_stds(1, sigma, max_norm, False)[0]


def _is_large(leaf: torch.Tensor) -> bool:
    return leaf.numel() >= pallas_clip.MIN_PALLAS_ELEMS


def draw_fused_noise(gen: torch.Generator, leaves: Sequence[torch.Tensor],
                     stds: torch.Tensor) -> FusedNoise:
    """One step's randomness of the fused route, drawn on the generator's
    device in this order: the per-leaf seeds (one ``torch.randint``), then the
    small leaves' normals. The small leaves share one flat draw while they
    total at most ``_FLAT_DRAW_MAX`` elements (disjoint slices of one draw are
    independent normals, so the DP guarantee is unchanged); past that each
    draws its own."""
    dev = gen.device
    seeds = torch.randint(0, 2 ** 63 - 1, (len(leaves),), generator=gen, device=dev,
                          dtype=torch.int64)
    small = [l for l in leaves if not _is_large(l)]
    total = sum(l.numel() for l in small)
    flat = (torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
            if 0 < total <= _FLAT_DRAW_MAX else None)
    eps: List[Optional[torch.Tensor]] = []
    off = 0
    for l in leaves:
        if _is_large(l):
            eps.append(None)
        elif flat is None:
            eps.append(torch.randn(l.shape, generator=gen, device=dev, dtype=torch.float32))
        else:
            eps.append(flat[off:off + l.numel()].reshape(l.shape))
            off += l.numel()
    return FusedNoise(seeds, eps, stds)


def weighted_sum_fused_noise(grads_ps: Params, factors: torch.Tensor,
                             fused: FusedNoise) -> Params:
    """Weighted sum with the DP noise fused in: leaves of at least
    ``pallas_clip.MIN_PALLAS_ELEMS`` elements go through K6 (one pass over the
    leaf, noise generated in registers from the leaf's seed); small leaves
    take the plain product plus their pre-drawn normals."""
    out = {}
    for i, (k, g) in enumerate(grads_ps.items()):
        if fused.eps[i] is None:
            out[k] = pallas_clip.leaf_weighted_sum_noise(g, factors[i], fused.seeds[i],
                                                         fused.stds[i])
        else:
            s = (factors[i] @ g.reshape(g.shape[0], -1)).reshape(g.shape[1:])
            out[k] = s + fused.stds[i] * fused.eps[i]
    return out


def two_pass_clipped_grad_sum(loss_fn: Callable, params: Params, *batch: torch.Tensor,
                              max_norm: MaxNorm, per_layer: bool = False
                              ) -> Tuple[Params, ClipStats]:
    """Clipped gradient sum without re-reading materialized per-sample grads.

    Pass 1 computes only the per-sample norms (vmap(grad) reduced to a norm
    per leaf at once). Pass 2 is one ordinary batched backward of
    sum_i w_i * loss_i with the clip factors as constants: exactly the clipped
    sum, since d/dp sum_i w_i l_i(p) = sum_i w_i g_i. Per-leaf factors differ
    across leaves, which one weighted backward cannot express, so per-layer
    clipping takes ``clipped_grad_sum``."""

    def norms_of(*example):
        g = grad(loss_fn)(params, *example)
        return torch.stack([torch.sqrt(torch.sum(leaf.float() ** 2)) for leaf in g.values()])

    norms = vmap(norms_of)(*batch).T                    # [n_leaves, batch]
    factors = clip_factors(norms, max_norm, per_layer)
    stats = stats_from_norms(norms, factors)
    if per_layer:
        summed, _ = clipped_grad_sum(loss_fn, params, *batch, max_norm=max_norm,
                                     per_layer=True)
        return summed, stats
    w = factors[0].detach()                             # flat: the same for every leaf

    def weighted_total(p):
        losses_ps = vmap(lambda *ex: loss_fn(p, *ex))(*batch)
        return torch.sum(w * losses_ps)

    return grad(weighted_total)(params), stats


def clipped_grad_sum(loss_fn: Callable, params: Params, *batch: torch.Tensor,
                     max_norm: MaxNorm, per_layer: bool = False,
                     chunk: Optional[int] = None,
                     fused_noise: Optional[FusedNoise] = None
                     ) -> Tuple[Params, ClipStats]:
    """Sum over samples of per-sample-clipped gradients, plus norm statistics
    (the equivalent of Opacus ``clip()`` and the grad-norm logging pass).

    With ``chunk``, a loop over zero-padded batch chunks bounds the
    per-sample-gradient memory by chunk x params; pad rows get factor 0 and
    are dropped from the statistics. With ``fused_noise`` (unchunked only) the
    Gaussian DP noise is added inside the weighted sum; noise addition
    commutes with the fake-pass and penalty gradients that may follow."""
    gfn = vmap(grad(loss_fn), in_dims=(None,) + (0,) * len(batch))

    def one_chunk(bc):
        g_ps = gfn(params, *bc)
        norms = leaf_norms(g_ps)
        return g_ps, norms, clip_factors(norms, max_norm, per_layer)

    if chunk is None:
        g_ps, norms, factors = one_chunk(batch)
        if fused_noise is not None:
            summed = weighted_sum_fused_noise(g_ps, factors, fused_noise)
        else:
            summed = weighted_sum(g_ps, factors)
        return summed, stats_from_norms(norms, factors)

    if fused_noise is not None:
        raise ValueError("fused_noise is not supported with chunked per-sample "
                         "grads; add noise separately")
    n = batch[0].shape[0]
    summed = {k: torch.zeros_like(v) for k, v in params.items()}
    norms_all, factors_all = [], []
    for mask, bc in _chunks(batch, chunk):
        g_ps, norms, factors = one_chunk(bc)
        factors = factors * mask[None, :]
        s = weighted_sum(g_ps, factors)
        summed = {k: summed[k] + s[k] for k in summed}
        norms_all.append(norms)
        factors_all.append(factors)
    norms = torch.cat(norms_all, dim=1)[:, :n]
    factors = torch.cat(factors_all, dim=1)[:, :n]
    return summed, stats_from_norms(norms, factors)


def noise_like(gen: torch.Generator, leaves: Sequence[torch.Tensor],
               std: Union[float, Sequence[float]], lead: tuple = ()) -> List[torch.Tensor]:
    """std * N(0, 1) for each leaf shape (one std, or one per leaf), with
    optional leading dims (a [steps, ...] draw for a whole epoch). Drawn on
    the generator's device."""
    stds = [std] * len(leaves) if isinstance(std, (int, float)) else list(std)
    return [torch.randn(lead + tuple(l.shape), generator=gen,
                        device=gen.device, dtype=torch.float32) * s
            for l, s in zip(leaves, stds)]


def add_gaussian_noise(gen: torch.Generator, leaves: Sequence[torch.Tensor],
                       sigma: float, max_norm: MaxNorm,
                       per_layer: bool = False) -> List[torch.Tensor]:
    """Add N(0, (sigma*C)^2) per parameter, std sigma*C_l in per-layer mode
    (the Opacus noise-at-step semantics, JAX ops/grads.py:289)."""
    stds = noise_stds(len(leaves), sigma, max_norm, per_layer)
    return [l + n for l, n in zip(leaves, noise_like(gen, leaves, stds))]
