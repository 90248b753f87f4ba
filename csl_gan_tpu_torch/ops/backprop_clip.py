"""Backpropagation clipping (experimental; reference backprop_clip.py:45-158):
the port's copy of the JAX package's ops/backprop_clip.py.

Instead of clipping per-sample parameter gradients after the fact, bound them
a priori by clipping (a) each layer's input activations in the forward pass
and (b) each layer's output cotangent in the backward pass. The product of
the two clip levels bounds every per-parameter gradient L2 norm, and those
bounds (scaled by batch size for the mean-reduced loss, train.py:89) become
the DP engine's per-layer clipping parameters (training/loop.py).

  - ``l2_clip(x, c)``: differentiable per-sample L2 clip (the forward path);
  - ``cotangent_clip(x, c)``: identity whose backward clips the per-sample
    cotangent (the reference's dummy-layer backward hook,
    backprop_clip.py:98-100), a ``torch.autograd.Function`` with a generated
    vmap rule, so it runs inside ``torch.func.vmap(grad(...))``, and with a
    differentiable backward, so second-order passes (immediate sensitivity)
    go through it;

and the bound derivation (``derive_bpc``) of the per-layer-type formulas
(backprop_clip.py:63-93). As in the reference, which hard-codes a
(1, 1, 28, 28) summary input (backprop_clip.py:124), only the MNIST vanilla
discriminator is supported. Plain PyTorch: no kernel of its own.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


def l2_clip(t: torch.Tensor, c) -> torch.Tensor:
    """Per-sample L2 clip over the non-batch dims (differentiable)."""
    dims = tuple(range(1, t.ndim))
    norm = torch.sqrt(torch.sum(t ** 2, dim=dims, keepdim=True) + 1e-12)
    return torch.where(norm > c, c * (t / norm), t)


class _CotangentClip(torch.autograd.Function):
    generate_vmap_rule = True

    @staticmethod
    def forward(x, c):
        return x.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.c = inputs[1]

    @staticmethod
    def backward(ctx, g):
        return l2_clip(g, ctx.c), None


def cotangent_clip(x: torch.Tensor, c: float) -> torch.Tensor:
    """x in the forward pass; its cotangent L2-clipped per sample to c."""
    return _CotangentClip.apply(x, float(c))


def l2_size(n: int, scale: float) -> float:
    """L2 norm of an n-element tensor with all entries = scale
    (reference backprop_clip.py:14-16)."""
    return float(np.sqrt(n * scale ** 2))


def l2_to_l1(l2: float, n: int) -> float:
    """(reference backprop_clip.py:24-25)"""
    return float(np.sqrt(n) * l2)


@dataclass
class LayerSpec:
    kind: str          # "linear" | "conv"
    in_shape: Tuple[int, ...]   # per-sample input shape
    out_shape: Tuple[int, ...]  # per-sample output shape
    weight_numel: int
    has_bias: bool


@dataclass
class BpcConfig:
    input_clip_params: List[float]   # per layer
    back_clip_params: List[float]    # per layer
    grad_l2_bounds: List[float]      # per parameter, torch order


def derive_bpc(layers: Sequence[LayerSpec],
               back_clip_params: Optional[Sequence[float]] = None,
               input_clip_params: Optional[Sequence[float]] = None,
               auto_activation_scale: float = 0.5,
               auto_weight_grad_scale: float = 1e-4) -> BpcConfig:
    """Per-layer clip params and per-parameter grad bounds
    (reference backprop_clip.py:63-93); automatic when either list is None."""
    auto = back_clip_params is None or input_clip_params is None
    in_clips, back_clips, bounds = [], [], []
    for i, layer in enumerate(layers):
        n_in = int(np.prod(layer.in_shape))
        n_out_sp = int(np.prod(layer.out_shape[1:])) if layer.kind == "conv" else 1
        if auto:
            ic = l2_size(n_in, auto_activation_scale)
            wb = l2_size(layer.weight_numel, auto_weight_grad_scale)
            if layer.kind == "linear":
                bc = wb / ic
                bounds.append(wb)
                if layer.has_bias:
                    bounds.append(bc)
            else:
                bc = l2_to_l1(wb, n_out_sp) / ic
                bounds.append(wb)
                if layer.has_bias:
                    bounds.append(bc * n_out_sp)
        else:
            ic = float(input_clip_params[i] if not np.isscalar(input_clip_params)
                       else input_clip_params)
            bc = float(back_clip_params[i] if not np.isscalar(back_clip_params)
                       else back_clip_params)
            if layer.kind == "linear":
                bounds.append(ic * bc)
                if layer.has_bias:
                    bounds.append(bc)
            else:
                bounds.append(ic * l2_to_l1(bc, n_out_sp))
                if layer.has_bias:
                    bounds.append(bc * n_out_sp)
        in_clips.append(ic)
        back_clips.append(bc)
    return BpcConfig(in_clips, back_clips, bounds)


def mnist_vanilla_d_layers(n_classes: int) -> List[LayerSpec]:
    """Layer specs of the MNIST vanilla discriminator (MNIST_models.py:36-39)."""
    nc = max(n_classes, 0)
    layers = [
        LayerSpec("linear", (784 + nc,), (128,), (784 + nc) * 128, True),
        LayerSpec("linear", (128,), (1,), 128, True),
    ]
    if nc > 1:
        layers.append(LayerSpec("linear", (128,), (nc,), 128 * nc, True))
    return layers


def bpc_config_for(opt) -> BpcConfig:
    """The config from the CLI flags (reference train.py:84-92 gating)."""
    if opt.model != "Vanilla" or opt.dataset != "MNIST":
        raise Exception("Backprop clipping is only supported for the MNIST "
                        "Vanilla model (matches the reference's (1,1,28,28) "
                        "assumption, backprop_clip.py:124).")
    n_classes = opt.n_classes if opt.conditional else 0
    layers = mnist_vanilla_d_layers(n_classes)
    per_layer = (opt.grad_clip_mode or "standard").endswith("-pl")
    if per_layer:
        back, fwd = opt.bpc_back_clip_param_pl, opt.bpc_forward_clip_param_pl
    else:
        back, fwd = opt.bpc_back_clip_param, opt.bpc_forward_clip_param
    if back is None or fwd is None:
        return derive_bpc(layers, None, None, opt.bpc_auto_activation_scale,
                          opt.bpc_auto_weight_grad_scale)
    if np.isscalar(back):
        back = [back] * len(layers)
    if np.isscalar(fwd):
        fwd = [fwd] * len(layers)
    return derive_bpc(layers, back, fwd)
