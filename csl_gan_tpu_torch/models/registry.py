"""Model selection and initialization (reference init_util.py:44-71).

Weights come from a ``torch.Generator`` seeded with ``opt.weights_seed``
(G first, then D; within a model, its Linear and Conv2d layers in module
order), independent of the run's other randomness: U(+-1/sqrt(fan_in)) for
weights and biases, GroupNorm scale 1 and bias 0. The values differ from the
JAX package's for the same seed (another generator); the distribution is the
same.
"""

from __future__ import annotations

import torch
from torch import nn

from csl_gan_tpu_torch.models import dcresnet, mnist
from csl_gan_tpu_torch.models.common import torch_kernel_init


def _dcresnet_pair(opt):
    if opt.dataset == "MNIST":
        return dcresnet.mnist_dcrn_g, dcresnet.mnist_dcrn_d
    if opt.im_size == 48:
        return dcresnet.celeba_g48, dcresnet.celeba_d48
    return dcresnet.celeba_g64, dcresnet.celeba_d64


def init_models(opt, device: torch.device):
    """(G, D) per config, on `device`: the MNIST vanilla pair, or the DCResNet
    pair with GroupNorm (per-sample-grad mode), bf16 compute under --bf16."""
    n_classes = opt.n_classes if opt.conditional else 0
    if opt.model == "Vanilla" and opt.dataset == "MNIST":
        G = mnist.MNISTVanillaG(z_dim=opt.g_latent_dim, n_classes=n_classes)
        D = mnist.MNISTVanillaD(n_classes=n_classes,
                                conditional_arch=opt.conditional_arch)
    elif opt.model == "DeepConvResNet":
        g_ctor, d_ctor = _dcresnet_pair(opt)
        dtype = torch.bfloat16 if opt.bf16 else None
        G = g_ctor(z_dim=opt.g_latent_dim, n_classes=n_classes, dtype=dtype)
        D = d_ctor(n_classes=n_classes, conditional_arch=opt.conditional_arch,
                   dtype=dtype)
    else:
        raise NotImplementedError(f"{opt.dataset}/{opt.model} is not ported yet")
    gen = torch.Generator().manual_seed(int(opt.weights_seed))
    for m in (G, D):
        for layer in m.modules():
            if isinstance(layer, (nn.Linear, nn.Conv2d)):
                torch_kernel_init(layer, gen)
    return G.to(device), D.to(device)
