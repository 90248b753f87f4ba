"""GAN losses of the vanilla family (reference models.py:20-67).

Every loss supports ``reduction='mean' | 'sum' | 'none'``; ``'none'`` returns
one value per sample (trailing dims averaged), as the JAX package's
models/losses.py does.
"""

from __future__ import annotations

import torch


def _reduce(elementwise: torch.Tensor, reduction: str):
    ps = elementwise if elementwise.ndim == 1 else \
        elementwise.reshape(elementwise.shape[0], -1).mean(dim=-1)
    if reduction == "mean":
        return ps.mean()
    if reduction == "sum":
        return ps.sum()
    if reduction == "none":
        return ps
    raise ValueError(f"unknown reduction {reduction}")


def bce_with_logits(logits, targets, reduction="mean"):
    """Numerically stable binary cross entropy on logits."""
    loss = (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
    return _reduce(loss, reduction)


def softmax_cross_entropy(logits, labels, reduction="mean"):
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), logits.shape[-1]).to(logp.dtype)
    return _reduce(-(logp * onehot).sum(dim=-1), reduction)


def _vanilla(family: str):
    if family != "vanilla":
        raise NotImplementedError(f"loss family {family!r} is not ported yet")


def g_adv_loss(family: str, d_out, reduction="mean"):
    _vanilla(family)
    return bce_with_logits(d_out, torch.ones_like(d_out), reduction)


def d_real_loss(family: str, d_out, reduction="mean"):
    _vanilla(family)
    return bce_with_logits(d_out, torch.ones_like(d_out), reduction)


def d_fake_loss(family: str, d_out, reduction="mean"):
    _vanilla(family)
    return bce_with_logits(d_out, torch.zeros_like(d_out), reduction)


def aux_loss(conditional_arch: str, aux_loss_type: str, aux_loss_scalar: float,
             aux_out, labels, n_classes: int, reduction="mean"):
    """ACGAN cross-entropy aux loss (nn.CrossEntropyLoss, models.py:51-67)."""
    if conditional_arch != "ACGAN" or aux_loss_type != "cross_entropy":
        raise NotImplementedError(
            f"aux loss {conditional_arch}/{aux_loss_type} is not ported yet")
    return aux_loss_scalar * softmax_cross_entropy(aux_out, labels, reduction)
