"""Gradient penalties (WGAN-GP, DRAGAN) as double-backward functions: the
port's copy of the JAX package's training/penalty.py.

The input gradient of sum_i D(x)_i is taken by ``torch.func.vjp`` of the D
forward, so the penalty's gradient w.r.t. D's params is a double backward
through D's layers (D has no norm layer), and the same code runs as one
sample's term inside ``torch.func.vmap(grad(...))`` (the per-sample penalty of
``-pupd false``). Penalty weight 10, several penalties averaged (reference
gradient_penalty.py:4-65). The draws are explicit inputs, one per penalty:
the interpolation weights alpha [B, 1, 1, 1] of WGAN-GP, the U(0, 1) noise
[B, ...] of DRAGAN.

DRAGAN perturbs the real data by std(real) * U(0, 1), the intended noise of
the reference (its ``random_(0, 1)`` draws zeros; the JAX package's note);
the std is the population std over the whole batch, or over the one row of a
per-sample term.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch.func import vjp

PENALTY_WEIGHT = 10.0


def lipschitz_penalty_wrt(d_apply: Callable, inputs: torch.Tensor,
                          input_labels: Optional[torch.Tensor],
                          one_sided: bool = False, aux_penalty: bool = True,
                          n_classes: int = 0, per_sample: bool = False,
                          batch_mean: Optional[Callable] = None):
    """((||d D(x)/d x||_2 - 1)_+)^2 per sample; with aux_penalty each aux-head
    column adds its own term (gradient_penalty.py:43-65). d_apply(x, y) ->
    (out, aux_out) must depend on D's params with autograd on (or be a
    function of params under ``torch.func``); it passes the labels to a D
    that conditions on them (CGAN, WCGAN). A WCGAN's head is its critic, and
    options turn aux_penalty off there, as the JAX package does, so its
    columns add no term. ``batch_mean`` maps the per-row terms to their
    batch mean (under a data axis: the mean over every rank's rows, the
    inputs being this rank's)."""
    inputs = inputs.detach()

    def fwd(x):
        out, aux_out = d_apply(x, input_labels)
        return (out,) if aux_out is None else (out, aux_out)

    outs, pullback = vjp(fwd, inputs)

    def penalty_of(cotangents):
        g, = pullback(cotangents)
        norms = torch.sqrt(g.reshape(g.shape[0], -1).square().sum(dim=1) + 1e-12)
        if one_sided:
            return torch.clamp(norms - 1.0, min=0.0).square()
        return (norms - 1.0).square()

    zeros = tuple(torch.zeros_like(o) for o in outs)
    gp = penalty_of((torch.ones_like(outs[0]),) + zeros[1:])
    if aux_penalty and n_classes > 1 and len(outs) > 1:
        aux_out = outs[1]
        cols = torch.arange(aux_out.shape[-1], device=aux_out.device)
        for col in range(n_classes):
            col_ct = (cols == col).to(aux_out.dtype).expand_as(aux_out)
            gp = gp + penalty_of((zeros[0], col_ct))
    if per_sample:
        return gp
    return gp.mean() if batch_mean is None else batch_mean(gp)


def wgan_gp_penalty(d_apply, real_data, real_labels, fake_data, alpha,
                    one_sided=False, aux_penalty=False, n_classes: int = 0,
                    per_sample: bool = False, weight: float = PENALTY_WEIGHT,
                    batch_mean: Optional[Callable] = None):
    """Penalty on x-interpolates alpha * real + (1 - alpha) * fake with
    alpha [B, 1, 1, 1] ~ U(0, 1) (gradient_penalty.py:31-41)."""
    interpolates = alpha * real_data + (1 - alpha) * fake_data
    return weight * lipschitz_penalty_wrt(
        d_apply, interpolates, real_labels, one_sided=one_sided,
        aux_penalty=aux_penalty, n_classes=n_classes, per_sample=per_sample,
        batch_mean=batch_mean)


def dragan_penalty(d_apply, real_data, real_labels, u, one_sided=False,
                   aux_penalty=False, n_classes: int = 0, per_sample: bool = False,
                   weight: float = PENALTY_WEIGHT, batch_mean: Optional[Callable] = None,
                   real_std: Optional[torch.Tensor] = None):
    """Penalty around real + std(real) * u, u ~ U(0, 1) shaped like the real
    data (gradient_penalty.py:20-29 with the intended noise); ``real_std``,
    when given, is the std of the whole batch whose rows these are."""
    std = torch.std(real_data, correction=0) if real_std is None else real_std
    noise = std * u
    return weight * lipschitz_penalty_wrt(
        d_apply, real_data + noise, real_labels, one_sided=one_sided,
        aux_penalty=aux_penalty, n_classes=n_classes, per_sample=per_sample,
        batch_mean=batch_mean)


def draw_shape(ptype: str, data_shape) -> tuple:
    """The shape of one penalty's draw for a batch of ``data_shape``: WGAN-GP
    alpha [B, 1, ...], DRAGAN's noise the data's own shape."""
    if ptype.startswith("DRAGAN"):
        return tuple(data_shape)
    return (data_shape[0],) + (1,) * (len(data_shape) - 1)


def calc_penalty(d_apply, penalty_types: Sequence[str], real_data, real_labels,
                 fake_data, draws: Sequence[torch.Tensor], aux_penalty=False,
                 n_classes: int = 0, per_sample: bool = False,
                 batch_mean: Optional[Callable] = None,
                 real_std: Optional[torch.Tensor] = None):
    """Mean over the configured penalties (gradient_penalty.py:4-18);
    ``draws[i]`` is the i-th penalty's draw (``draw_shape``). Under a data
    axis the batch is a rank's rows: ``batch_mean`` takes the mean over the
    whole batch's rows and ``real_std`` is the whole real batch's std
    (DRAGAN); the value is then the whole batch's, on every rank."""
    if not penalty_types:
        return torch.zeros((), device=real_data.device)
    total = 0.0
    w = 1.0 / len(penalty_types)
    for ptype, draw in zip(penalty_types, draws):
        kw = dict(one_sided=ptype.endswith("1"), aux_penalty=aux_penalty,
                  n_classes=n_classes, per_sample=per_sample, batch_mean=batch_mean)
        if ptype.startswith("DRAGAN"):
            p = dragan_penalty(d_apply, real_data, real_labels, draw, real_std=real_std, **kw)
        elif ptype.startswith("WGAN-GP"):
            p = wgan_gp_penalty(d_apply, real_data, real_labels, fake_data, draw, **kw)
        else:
            raise Exception("Unknown penalty type: " + ptype)
        total = total + w * p
    return total
