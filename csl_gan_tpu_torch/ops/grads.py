"""Per-sample gradient computation, clipping and noising: the port of the JAX
package's ops/grads.py.

  - ``per_sample_grads``: materialized per-sample gradients,
    ``vmap(grad(per_sample_loss))`` over a functional model call, optionally
    in chunks of the batch.
  - ``clipped_grad_sum``: per-sample L2 norms (flat or per leaf), clip factors
    min(1, C / norm) and the weighted sum; the clipped per-sample gradients
    are never formed, only a [batch] weight vector contracts against each
    leaf. With ``fused_noise`` the sums of the large leaves and their DP
    noise come from one K6 launch (ops/pallas_clip.py).
  - ``two_pass_clipped_grad_sum``: a norms-only pass, then one ordinary
    backward of sum_i w_i * loss_i.
  - ``add_gaussian_noise``: std sigma * C (flat) or sigma * C_l per leaf, which
    keeps the effective noise multiplier exactly sigma in both modes.
  - ``unit_normals`` / ``add_scaled_noise``: the noise of a step whose per-leaf
    stds are data-dependent (immediate sensitivity; gc under adaptive
    clipping, sigma times each step's thresholds): one N(0, 1) draw sliced
    per leaf, scaled on the device by an fp32 ``[n_leaves]`` tensor of stds,
    with no read to the host.
  - ``per_leaf_norms`` / ``global_norm`` of one (unbatched) gradient.
  - ``mask_loss``: a per-sample loss times the row's validity (Poisson
    subsampling), so masked rows add nothing to the clipped sum.

Params are dicts of torch state-dict names; per-sample gradients are dicts of
the same names with a leading [batch] axis. Per-leaf vectors (norms, factors,
clip statistics, thresholds, noise stds) follow the order of the params dict
given, which the callers keep in the JAX package's leaf order
(``StepBuilder.d_leaves``).

Under a model axis (``--tp``) a leaf may be this rank's slice of its output
channels: its per-sample gradients are the slice's, and ``sq_reduce`` (the
step builder's) sums the slices' squared norms over the model group before
the square root, so every leaf's norm enters the flat norm once (also in
``per_leaf_norms`` / ``global_norm`` of one gradient, differentiably: the
immediate-sensitivity step differentiates them); the sums
are this rank's slices, and K6 draws each slice's noise at the slice's
counter base (``FusedNoise.bases``), the one-device draw's elements.
"""

from __future__ import annotations

from typing import (Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch
from torch.func import grad, vmap

from csl_gan_tpu_torch.ops import pallas_clip

Params = Dict[str, torch.Tensor]
MaxNorm = Union[float, Sequence[float], torch.Tensor]

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
    # Per leaf, the flat index in the whole leaf of the first element this
    # rank holds (its model slice under --tp); None: every leaf whole.
    bases: Optional[List[int]] = None


def leaf_norms(grads_ps: Params, sq_reduce: Optional[Callable] = None) -> torch.Tensor:
    """Per-sample L2 norm of each leaf: [n_leaves, batch]. ``sq_reduce``
    maps the [n_leaves, batch] squared norms first (the model axis's sum of
    the slices' squares)."""
    sq = torch.stack([torch.sum(g.reshape(g.shape[0], -1) ** 2, dim=1)
                      for g in grads_ps.values()])
    return torch.sqrt(sq if sq_reduce is None else sq_reduce(sq))


def clip_factors(leaf_norms: torch.Tensor, max_norm: MaxNorm,
                 per_layer: bool) -> torch.Tensor:
    """Clipping factors per (leaf, sample), shape [n_leaves, batch]: one
    flat norm per sample (flat mode) or one threshold per leaf. The
    thresholds may be host floats or, under adaptive clipping, an fp32
    device tensor, which is never read back to the host."""
    if per_layer:
        thr = torch.as_tensor(max_norm, dtype=torch.float32,
                              device=leaf_norms.device)[:, None]
        return torch.clamp(thr / (leaf_norms + 1e-12), max=1.0)
    flat = torch.sqrt(torch.sum(leaf_norms ** 2, dim=0, keepdim=True))
    c = max_norm if isinstance(max_norm, torch.Tensor) else float(max_norm)
    factor = torch.clamp(c / (flat + 1e-12), max=1.0)
    return factor.expand(leaf_norms.shape)


def weighted_sum(grads_ps: Params, factors: torch.Tensor) -> Params:
    """sum_i factors[l, i] * grads_ps[l][i] as one fp32 product per leaf; the
    clipped per-sample gradients are not formed."""
    return {k: (factors[i] @ g.reshape(g.shape[0], -1)).reshape(g.shape[1:])
            for i, (k, g) in enumerate(grads_ps.items())}


def stats_from_norms(leaf_norms: torch.Tensor, factors: torch.Tensor,
                     gather: Optional[Callable] = None) -> ClipStats:
    """The batch's ClipStats of [n_leaves, batch] norms and factors. Under a
    data axis ``gather`` maps this rank's columns to the whole batch's
    (``MeshContext.gather_cols``), so the statistics are the batch's."""
    if gather is not None:
        leaf_norms, factors = gather(leaf_norms), gather(factors)
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
    """Weighted sum with the DP noise fused in: the leaves of at least
    ``pallas_clip.MIN_PALLAS_ELEMS`` elements go through K6 together (one
    launch reads each leaf once and generates its noise from the leaf's
    seed); small leaves take the plain product plus their pre-drawn
    normals. K6 takes row-major leaves: ``vmap`` gives them so on the card
    (where K6 raises on any other layout), and on the CPU a per-sample conv
    weight gradient may come permuted, so there it is laid out first (the
    copy the plain product's reshape made)."""
    items = list(grads_ps.items())
    large = [i for i in range(len(items)) if fused.eps[i] is None]
    summed = {}
    if large:
        bases = [0 if fused.bases is None else fused.bases[i] for i in large]
        gs = [items[i][1] for i in large]
        outs = pallas_clip.leaves_weighted_sum_noise(
            [g if g.is_cuda else g.contiguous() for g in gs], [factors[i] for i in large],
            fused.seeds, fused.stds, bases, large)
        summed = dict(zip(large, outs))
    out = {}
    for i, (k, g) in enumerate(items):
        if i in summed:
            out[k] = summed[i]
        else:
            s = (factors[i] @ g.reshape(g.shape[0], -1)).reshape(g.shape[1:])
            out[k] = s + fused.stds[i] * fused.eps[i]
    return out


def mask_loss(loss_fn: Callable, batch: tuple, valid: Optional[torch.Tensor]):
    """(loss_fn, batch) with each sample's loss multiplied by its validity
    weight ``valid`` [B] (the JAX package's ``_mask_loss``, steps.py:678-688):
    masked rows get gradient exactly zero, so the clipped sum runs over the
    valid rows only. Unchanged when ``valid`` is None."""
    if valid is None:
        return loss_fn, batch

    def masked(params, vi, *example):
        return vi * loss_fn(params, *example)

    return masked, (valid,) + tuple(batch)


def two_pass_clipped_grad_sum(loss_fn: Callable, params: Params, *batch: torch.Tensor,
                              max_norm: MaxNorm, per_layer: bool = False,
                              stats_gather: Optional[Callable] = None,
                              sq_reduce: Optional[Callable] = None
                              ) -> Tuple[Params, ClipStats]:
    """Clipped gradient sum without re-reading materialized per-sample grads.

    Pass 1 computes only the per-sample norms (vmap(grad) reduced to a norm
    per leaf at once). Pass 2 is one ordinary batched backward of
    sum_i w_i * loss_i with the clip factors as constants: exactly the clipped
    sum, since d/dp sum_i w_i l_i(p) = sum_i w_i g_i. Per-leaf factors differ
    across leaves, which one weighted backward cannot express, so per-layer
    clipping takes ``clipped_grad_sum``. The sum is over the rows given (a
    rank's rows under a data axis: the caller reduces it); ``stats_gather``
    and ``sq_reduce`` as in ``stats_from_norms`` and ``leaf_norms``."""

    def sq_norms_of(*example):
        g = grad(loss_fn)(params, *example)
        return torch.stack([torch.sum(leaf.float() ** 2) for leaf in g.values()])

    sq = vmap(sq_norms_of)(*batch).T                    # [n_leaves, batch]
    norms = torch.sqrt(sq if sq_reduce is None else sq_reduce(sq))
    factors = clip_factors(norms, max_norm, per_layer)
    stats = stats_from_norms(norms, factors, stats_gather)
    if per_layer:
        summed, _ = clipped_grad_sum(loss_fn, params, *batch, max_norm=max_norm,
                                     per_layer=True, sq_reduce=sq_reduce)
        return summed, stats
    w = factors[0].detach()                             # flat: the same for every leaf

    def weighted_total(p):
        losses_ps = vmap(lambda *ex: loss_fn(p, *ex))(*batch)
        return torch.sum(w * losses_ps)

    return grad(weighted_total)(params), stats


def clipped_grad_sum(loss_fn: Callable, params: Params, *batch: torch.Tensor,
                     max_norm: MaxNorm, per_layer: bool = False,
                     chunk: Optional[int] = None,
                     fused_noise: Optional[FusedNoise] = None,
                     stats_gather: Optional[Callable] = None,
                     sq_reduce: Optional[Callable] = None
                     ) -> Tuple[Params, ClipStats]:
    """Sum over samples of per-sample-clipped gradients, plus norm statistics
    (the equivalent of Opacus ``clip()`` and the grad-norm logging pass).

    With ``chunk``, a loop over zero-padded batch chunks bounds the
    per-sample-gradient memory by chunk x params; pad rows get factor 0 and
    are dropped from the statistics. With ``fused_noise`` (unchunked only) the
    Gaussian DP noise is added inside the weighted sum; noise addition
    commutes with the fake-pass and penalty gradients that may follow.

    Under a data axis the sum (and its noise, which only one rank adds: the
    others pass zero stds) is over this rank's rows, and the caller reduces
    it; ``stats_gather`` as in ``stats_from_norms``, ``sq_reduce`` as in
    ``leaf_norms``."""
    gfn = vmap(grad(loss_fn), in_dims=(None,) + (0,) * len(batch))

    def one_chunk(bc):
        g_ps = gfn(params, *bc)
        norms = leaf_norms(g_ps, sq_reduce)
        return g_ps, norms, clip_factors(norms, max_norm, per_layer)

    if chunk is None:
        g_ps, norms, factors = one_chunk(batch)
        if fused_noise is not None:
            summed = weighted_sum_fused_noise(g_ps, factors, fused_noise)
        else:
            summed = weighted_sum(g_ps, factors)
        return summed, stats_from_norms(norms, factors, stats_gather)

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
    return summed, stats_from_norms(norms, factors, stats_gather)


def noise_like(gen: torch.Generator, leaves: Sequence[torch.Tensor],
               std: Union[float, Sequence[float]], lead: tuple = ()) -> List[torch.Tensor]:
    """std * N(0, 1) for each leaf shape (one std, or one per leaf), with
    optional leading dims (a [steps, ...] draw for a whole epoch). Drawn on
    the generator's device."""
    stds = [std] * len(leaves) if isinstance(std, (int, float)) else list(std)
    return [torch.randn(lead + tuple(l.shape), generator=gen,
                        device=gen.device, dtype=torch.float32) * s
            for l, s in zip(leaves, stds)]


def unit_normals(gen: torch.Generator, leaves: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """N(0, 1) shaped like each leaf: one flat draw on the generator's device,
    sliced per leaf (disjoint slices of one draw are independent normals)."""
    total = sum(l.numel() for l in leaves)
    flat = torch.randn(total, generator=gen, device=gen.device, dtype=torch.float32)
    out, off = [], 0
    for l in leaves:
        out.append(flat[off:off + l.numel()].reshape(l.shape))
        off += l.numel()
    return out


def add_scaled_noise(leaves: Sequence[torch.Tensor], eps: Sequence[torch.Tensor],
                     stds: torch.Tensor) -> List[torch.Tensor]:
    """leaves[l] + stds[l] * eps[l], with ``stds`` an fp32 ``[n_leaves]`` tensor
    on the leaves' device (JAX ``add_gaussian_noise(key, grads, 1.0, stds,
    per_layer=True)``)."""
    return [g + stds[i] * e for i, (g, e) in enumerate(zip(leaves, eps))]


def _leaf_sq(leaves: Sequence[torch.Tensor], sq_reduce: Callable) -> torch.Tensor:
    """``[n_leaves]`` squared norms in fp32, mapped by ``sq_reduce`` as one
    [n_leaves, 1] column (differentiable: the model axis's sum)."""
    sq = torch.stack([torch.sum(g.float() ** 2) for g in leaves])
    return sq_reduce(sq[:, None])[:, 0]


def per_leaf_norms(leaves: Sequence[torch.Tensor],
                   sq_reduce: Optional[Callable] = None) -> torch.Tensor:
    """L2 norm of each leaf, in fp32: ``[n_leaves]``; ``sq_reduce`` as in
    ``leaf_norms`` (each sharded leaf's norm is then the whole leaf's)."""
    if sq_reduce is None:
        return torch.stack([torch.sqrt(torch.sum(g.float() ** 2)) for g in leaves])
    return torch.sqrt(_leaf_sq(leaves, sq_reduce))


def global_norm(leaves: Sequence[torch.Tensor],
                sq_reduce: Optional[Callable] = None) -> torch.Tensor:
    """L2 norm of all leaves together, in fp32; ``sq_reduce`` as in
    ``per_leaf_norms``."""
    if sq_reduce is None:
        return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    return torch.sqrt(torch.sum(_leaf_sq(leaves, sq_reduce)))


def add_gaussian_noise(gen: torch.Generator, leaves: Sequence[torch.Tensor],
                       sigma: float, max_norm: MaxNorm,
                       per_layer: bool = False) -> List[torch.Tensor]:
    """Add N(0, (sigma*C)^2) per parameter, std sigma*C_l in per-layer mode
    (the Opacus noise-at-step semantics, JAX ops/grads.py:289)."""
    stds = noise_stds(len(leaves), sigma, max_norm, per_layer)
    return [l + n for l, n in zip(leaves, noise_like(gen, leaves, stds))]
