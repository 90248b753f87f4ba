"""GAN losses (reference models.py:20-67): the vanilla (BCE) and wgan
families, and the conditional auxiliary losses.

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


def _family(family: str):
    if family not in ("vanilla", "wgan"):
        raise ValueError(family)
    return family == "vanilla"


def g_adv_loss(family: str, d_out, reduction="mean"):
    if _family(family):
        return bce_with_logits(d_out, torch.ones_like(d_out), reduction)
    return _reduce(-d_out, reduction)          # -mean(d_out)


def d_real_loss(family: str, d_out, reduction="mean"):
    if _family(family):
        return bce_with_logits(d_out, torch.ones_like(d_out), reduction)
    return _reduce(-d_out, reduction)


def d_fake_loss(family: str, d_out, reduction="mean"):
    if _family(family):
        return bce_with_logits(d_out, torch.zeros_like(d_out), reduction)
    return _reduce(d_out, reduction)


def aux_loss(conditional_arch: str, aux_loss_type: str, aux_loss_scalar: float,
             aux_out, labels, n_classes: int, reduction="mean"):
    """Conditional auxiliary loss (reference models.py:51-67).

    ACGAN cross_entropy: mean CE (nn.CrossEntropyLoss). ACGAN wasserstein:
    the class-balanced +-sigmoid *sum* (models.py:54) -- a sum-formulated
    loss, so 'mean' returns the batch total and 'none' per-sample terms
    summing to it; each row is divided by the count of its class in the
    batch. WCGAN, or a D without an aux head: zero (a WCGAN conditions in
    its critic head, models.py:57-67)."""
    if aux_out is None or conditional_arch == "WCGAN":
        dev = labels.device
        return torch.zeros(labels.shape[0], device=dev) if reduction == "none" else \
            torch.zeros((), device=dev)
    if conditional_arch != "ACGAN":
        raise ValueError(conditional_arch)
    if aux_loss_type == "cross_entropy":
        return aux_loss_scalar * softmax_cross_entropy(aux_out, labels, reduction)
    onehot = torch.nn.functional.one_hot(labels.long(), n_classes).to(aux_out.dtype)
    sign = onehot * -2.0 + 1.0
    row_norm = (onehot @ onehot.sum(dim=0))[:, None]
    per_elem = sign * torch.sigmoid(aux_out) / row_norm
    if reduction == "none":
        return aux_loss_scalar * per_elem.sum(dim=-1)
    return aux_loss_scalar * per_elem.sum()
