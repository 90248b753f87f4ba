"""MNIST vanilla MLP GAN (reference MNIST_models.py:9-52) as nn.Modules.

Same widths and layer names as the JAX package's models/mnist.py: G
z (+one-hot y) -> 128 -> 784 -> sigmoid; D flatten(x) (+one-hot y) ->
128 -> {1, aux n_classes}. The one-hot label is concatenated for every
conditional arch; only ACGAN has the aux head (CGAN and WCGAN conditioning
is the concat alone), and an unconditional pair takes no label. Images stay
NHWC (B, 28, 28, 1) at the public functions, as in the JAX package.

Under a model axis (``--tp``; the forwards' ``mesh``) a layer whose weight
arrives as this rank's slice of output features is column-parallel
(``linear``): its input enters through ``mesh.copy_model``, a replicated
bias is sliced, and its output is gathered over the model group. Under
``--backprop_clip`` the clips wrap ``linear``: the input clip sees the
whole input, the cotangent clip the whole (gathered) output's cotangent.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.ops import backprop_clip

# Leaf order of the JAX package's flattened param trees (sorted keys: bias
# before kernel in each module), in torch state-dict names. The epoch kernel,
# the ghost clip stats and the DP noise all use this order; D_LEAVES is the
# ACGAN D's (``d_leaves`` gives any D's).
D_LEAVES = ("lin1.bias", "lin1.weight", "lin2.bias", "lin2.weight",
            "linOutAux.bias", "linOutAux.weight")
G_LEAVES = ("lin1.bias", "lin1.weight", "lin2.bias", "lin2.weight")


def linear(x: torch.Tensor, lin: nn.Linear, mesh=None) -> torch.Tensor:
    """``lin(x)``; under a model axis with ``lin.weight`` this rank's slice
    of the output features, this rank's features gathered over the model
    group."""
    w, b = lin.weight, lin.bias
    if mesh is None or w.shape[0] == lin.out_features:
        return F.linear(x, w, b)
    if b is not None and b.shape[0] != w.shape[0]:
        b = mesh.split_model(b, 0)
    return mesh.gather_model(F.linear(mesh.copy_model(x), w, b), -1)


class MNISTVanillaG(nn.Module):
    family = "vanilla"

    def __init__(self, z_dim: int = 100, n_classes: int = 0, out_ch: int = 1):
        super().__init__()
        self.n_classes = n_classes
        self.out_ch = out_ch
        self.lin1 = nn.Linear(z_dim + n_classes, 128)
        self.lin2 = nn.Linear(128, 784 * out_ch)

    def forward(self, z: torch.Tensor, y: Optional[torch.Tensor] = None, mesh=None):
        x = z
        if y is not None:
            x = torch.cat([x, one_hot(y, self.n_classes)], dim=1)
        x = torch.relu(linear(x, self.lin1, mesh))
        x = torch.sigmoid(linear(x, self.lin2, mesh))
        return x.reshape(z.shape[0], 28, 28, self.out_ch)


class MNISTVanillaD(nn.Module):
    """The vanilla D concatenates the label one-hot for any conditional arch,
    ACGAN included (reference MNIST_models.py:41-46). As in the JAX
    package, a conditional vanilla D takes only the cross-entropy aux loss.

    With ``bpc_fwd`` / ``bpc_back`` (per-layer clip levels) set and
    ``bpc=True`` passed, each layer's input activations are L2-clipped in the
    forward pass and its output cotangent in the backward pass: the
    backprop clipping of reference backprop_clip.py (ops/backprop_clip.py)."""
    family = "vanilla"

    def __init__(self, n_classes: int = 0, conditional_arch: str = "ACGAN",
                 aux_loss_type: str = "cross_entropy", bpc_fwd=None, bpc_back=None):
        super().__init__()
        if n_classes > 1 and aux_loss_type != "cross_entropy":
            raise Exception("Cross entropy loss is the only aux loss supported for "
                            "vanilla architecture.")
        self.n_classes = n_classes
        self.conditional_arch = conditional_arch
        self.bpc_fwd, self.bpc_back = bpc_fwd, bpc_back
        self.lin1 = nn.Linear(784 + n_classes, 128)
        self.lin2 = nn.Linear(128, 1)
        if n_classes > 1 and conditional_arch == "ACGAN":
            self.linOutAux = nn.Linear(128, n_classes)

    def _layer(self, idx: int, lin: nn.Linear, o, bpc: bool, mesh=None):
        if bpc and self.bpc_fwd is not None:
            # The clips act on the layer's whole input and gathered output,
            # the same on every model rank: each is the whole layer's.
            return backprop_clip.cotangent_clip(
                linear(backprop_clip.l2_clip(o, self.bpc_fwd[idx]), lin, mesh),
                self.bpc_back[idx])
        return linear(o, lin, mesh)

    def forward(self, x: torch.Tensor, y: Optional[torch.Tensor] = None,
                aux: bool = True, bpc: bool = False, mesh=None):
        o = x.reshape(x.shape[0], -1)
        if y is not None:
            o = torch.cat([o, one_hot(y, self.n_classes)], dim=1)
        o = torch.relu(self._layer(0, self.lin1, o, bpc, mesh))
        out = self._layer(1, self.lin2, o, bpc, mesh)
        aux_out = None
        if aux and hasattr(self, "linOutAux"):
            aux_out = self._layer(2, self.linOutAux, o, bpc, mesh)
        return out, aux_out


def d_leaves(D: MNISTVanillaD):
    """D's state-dict names in the JAX leaf order (D_LEAVES without the aux
    head when D has none)."""
    return D_LEAVES if hasattr(D, "linOutAux") else D_LEAVES[:4]
