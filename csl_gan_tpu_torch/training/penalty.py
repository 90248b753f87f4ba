"""Gradient penalties (WGAN-GP) as double-backward functions: the port's copy
of the JAX package's training/penalty.py.

The input gradient of sum_i D(x)_i is taken with
``torch.autograd.grad(..., create_graph=True)``, so the penalty's gradient
w.r.t. D's params is a double backward through D's convs (D has no norm
layer). Penalty weight 10, several penalties averaged (reference
gradient_penalty.py:4-65). The interpolation weights are an explicit input.
DRAGAN is not ported.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

PENALTY_WEIGHT = 10.0


def lipschitz_penalty_wrt(d_apply: Callable, inputs: torch.Tensor,
                          input_labels: Optional[torch.Tensor],
                          one_sided: bool = False, aux_penalty: bool = True,
                          n_classes: int = 0, per_sample: bool = False):
    """((||d D(x)/d x||_2 - 1)_+)^2 per sample; with aux_penalty each aux-head
    column adds its own term (gradient_penalty.py:43-65). d_apply(x, y) ->
    (out, aux_out) must depend on D's params with autograd on."""
    inputs = inputs.detach().requires_grad_(True)
    out, aux_out = d_apply(inputs, input_labels)

    def penalty_of(scalar):
        g, = torch.autograd.grad(scalar, inputs, create_graph=True)
        norms = torch.sqrt(g.reshape(g.shape[0], -1).square().sum(dim=1) + 1e-12)
        if one_sided:
            return torch.clamp(norms - 1.0, min=0.0).square()
        return (norms - 1.0).square()

    gp = penalty_of(out.sum())
    if aux_penalty and n_classes > 1 and aux_out is not None:
        for col in range(n_classes):
            gp = gp + penalty_of(aux_out[:, col].sum())
    return gp if per_sample else gp.mean()


def wgan_gp_penalty(d_apply, real_data, real_labels, fake_data, alpha,
                    one_sided=False, aux_penalty=False, n_classes: int = 0,
                    per_sample: bool = False, weight: float = PENALTY_WEIGHT):
    """Penalty on x-interpolates alpha * real + (1 - alpha) * fake with
    alpha [B, 1, 1, 1] ~ U(0, 1) (gradient_penalty.py:31-41)."""
    interpolates = alpha * real_data + (1 - alpha) * fake_data
    return weight * lipschitz_penalty_wrt(
        d_apply, interpolates, real_labels, one_sided=one_sided,
        aux_penalty=aux_penalty, n_classes=n_classes, per_sample=per_sample)


def calc_penalty(d_apply, penalty_types: Sequence[str], real_data, real_labels,
                 fake_data, alphas: Sequence[torch.Tensor], aux_penalty=False,
                 n_classes: int = 0, per_sample: bool = False):
    """Mean over the configured penalties (gradient_penalty.py:4-18);
    ``alphas[i]`` is the i-th penalty's interpolation weight draw."""
    if not penalty_types:
        return torch.zeros((), device=real_data.device)
    total = 0.0
    w = 1.0 / len(penalty_types)
    for ptype, alpha in zip(penalty_types, alphas):
        if not ptype.startswith("WGAN-GP"):
            raise NotImplementedError(f"penalty {ptype} is not ported yet")
        p = wgan_gp_penalty(d_apply, real_data, real_labels, fake_data, alpha,
                            one_sided=ptype.endswith("1"),
                            aux_penalty=aux_penalty, n_classes=n_classes,
                            per_sample=per_sample)
        total = total + w * p
    return total
