"""Model selection and initialization (reference init_util.py:44-71).

Weights come from a ``torch.Generator`` seeded with ``opt.weights_seed``
(G first, then D), independent of the run's other randomness. The values
differ from the JAX package's for the same seed (another generator); the
distribution is the same.
"""

from __future__ import annotations

import torch

from csl_gan_tpu_torch.models import mnist
from csl_gan_tpu_torch.models.common import init_linear


def init_models(opt, device: torch.device):
    """(G, D) for the MNIST vanilla pair, on `device`."""
    if opt.dataset != "MNIST" or opt.model != "Vanilla":
        raise NotImplementedError(f"{opt.dataset}/{opt.model} is not ported yet")
    n_classes = opt.n_classes if opt.conditional else 0
    G = mnist.MNISTVanillaG(z_dim=opt.g_latent_dim, n_classes=n_classes)
    D = mnist.MNISTVanillaD(n_classes=n_classes,
                            conditional_arch=opt.conditional_arch)
    gen = torch.Generator().manual_seed(int(opt.weights_seed))
    for m in (G, D):
        for layer in m.children():
            init_linear(layer, gen)
    return G.to(device), D.to(device)
