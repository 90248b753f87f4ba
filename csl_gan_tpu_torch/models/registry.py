"""Model selection and initialization (reference init_util.py:44-71).

Weights come from a ``torch.Generator`` seeded with ``opt.weights_seed``
(G first, then D; within a model, its Linear and Conv2d layers in module
order), independent of the run's other randomness: U(+-1/sqrt(fan_in)) for
weights and biases, N(0, 1) for a label embedding (the G's ``Embed_0``),
GroupNorm scale 1 and bias 0. The values differ from the
JAX package's for the same seed (another generator); the distribution is the
same.
"""

from __future__ import annotations

import torch
from torch import nn

from csl_gan_tpu_torch.models import dcresnet, mnist
from csl_gan_tpu_torch.models.common import torch_kernel_init
from csl_gan_tpu_torch.ops.backprop_clip import bpc_config_for


def _dcresnet_pair(opt):
    if opt.dataset == "MNIST":
        return dcresnet.mnist_dcrn_g, dcresnet.mnist_dcrn_d
    if opt.im_size == 48:
        return dcresnet.celeba_g48, dcresnet.celeba_d48
    return dcresnet.celeba_g64, dcresnet.celeba_d64


def init_models(opt, device: torch.device):
    """(G, D) per config, on `device`: the MNIST vanilla pair, or the DCResNet
    pair (the G's label mode and the D's conditional arch as configured),
    bf16 compute under --bf16 (the vanilla MLP computes fp32 whatever the
    flag, as the JAX package's does), whose G has GroupNorm when per-sample
    gradients are on (-dpm gc / tm / sv) and BatchNorm otherwise (the JAX
    package's ``bn = not per_sample_grad``) and, under
    ``--ref_pixel_shuffle``, the reference's pixel-shuffle upsampling (the
    flag has no effect on the vanilla model, as in the JAX package). Under
    ``--backprop_clip`` the vanilla D gets its per-layer clip levels
    (``bpc_config_for``, which refuses any other model with the JAX
    package's message). CelebA has no vanilla pair: the JAX package's
    error."""
    n_classes = opt.n_classes if opt.conditional else 0
    if opt.model == "Vanilla" and opt.dataset == "MNIST":
        G = mnist.MNISTVanillaG(z_dim=opt.g_latent_dim, n_classes=n_classes)
        bpc = {}
        if opt.backprop_clip:
            cfg = bpc_config_for(opt)
            bpc = {"bpc_fwd": tuple(cfg.input_clip_params),
                   "bpc_back": tuple(cfg.back_clip_params)}
        D = mnist.MNISTVanillaD(n_classes=n_classes,
                                conditional_arch=opt.conditional_arch,
                                aux_loss_type=opt.aux_loss_type, **bpc)
    elif opt.model == "DeepConvResNet":
        if opt.backprop_clip:
            bpc_config_for(opt)     # raises: the MNIST vanilla D only
        g_ctor, d_ctor = _dcresnet_pair(opt)
        dtype = torch.bfloat16 if opt.bf16 else None
        G = g_ctor(z_dim=opt.g_latent_dim, n_classes=n_classes,
                   emb_mode=opt.g_label_emb_mode, dtype=dtype, bn=not opt.per_sample_grad,
                   ref_ps=bool(opt.ref_pixel_shuffle))
        D = d_ctor(n_classes=n_classes, conditional_arch=opt.conditional_arch,
                   dtype=dtype)
    elif opt.model == "Vanilla":
        raise Exception("No vanilla architecture for CelebA.")
    else:
        raise Exception(f"Unknown dataset/model: {opt.dataset}/{opt.model}")
    gen = torch.Generator().manual_seed(int(opt.weights_seed))
    for m in (G, D):
        for layer in m.modules():
            if isinstance(layer, (nn.Linear, nn.Conv2d)):
                torch_kernel_init(layer, gen)
            elif isinstance(layer, nn.Embedding):
                with torch.no_grad():
                    layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen))
    return G.to(device), D.to(device)
