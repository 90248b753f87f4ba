"""Ghost (norm-factorized) per-sample clipping for the DCResNet discriminator.

The port's counterpart of the JAX package's ops/conv_ghost.py
``dcresnet_real_ghost``: the private REAL pass of the conv D computes
per-sample gradient NORMS from layer inputs and output cotangents, then the
clip-weighted gradient sum with the cotangents scaled by the clip factors, and
never forms per-sample gradients.

Per conv layer the kernel-gradient norm takes one of two orders (the
"mixed ghost clipping" rule, ``_ghost_order``):

    direct:  ||g_W(i)||^2 = || U_i^T C_i ||_F^2     (F.unfold patches + einsum)
    ghost:   ||g_W(i)||^2 = <U_i U_i^T, C_i C_i^T>  (K2, ops/pallas_conv_ghost.py)

and the weighted kernel sum is the einsum over the same patches (direct
layers) or K3 (ghost layers). The layer choice keeps the JAX package's
constant ``ai = 240`` (a TPU arithmetic intensity) so the two packages clip
the same layers the same way; on the CelebA flagship the ghost layers are
conv2, conv3 and conv4. The JAX package sends conv4 to XLA only because its
13 MB fp32 accumulator exceeds the TPU kernel's 4 MB VMEM gate; here K2/K3
serve every ghost-order layer, conv4 included.

Dense heads use ||g_W(i)|| = ||a_i|| * ||c_i||. Under bf16 compute the
forward and the input backprop run in bf16, norms and sums accumulate in fp32,
the weighted sums are fp32, and the clip norms carry ``_BF16_NORM_MARGIN``.
The DP noise is pre-drawn and added by the caller (training/steps.py).

Params are torch state-dict names (models/dcresnet.py); norms and ClipStats
follow the JAX leaf order (``dcresnet.d_leaves``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.models.dcresnet import conv_nhwc, dense
from csl_gan_tpu_torch.ops import pallas_conv_ghost as pcg
from csl_gan_tpu_torch.ops.grads import clip_factors, stats_from_norms

# The clip factors scale bf16 cotangents, whose rounding perturbs each
# per-sample contribution by <= 2^-8 relative; inflating the norms by 2^-7
# keeps ||f_i * g_i|| <= C (the JAX package's ops/conv_ghost.py:47).
_BF16_NORM_MARGIN = 1.0 + 2.0 ** -7


def _ghost_order(s: int, k: int, o: int) -> bool:
    """The JAX package's order choice (ops/conv_ghost.py:75-87): each order
    scored as max(flop time, byte time) at ai = 240 flop/byte."""
    ai = 240.0
    ghost_cost = max(2.0 * s * s * (k + o), ai * 12.0 * s * s)
    direct_cost = max(2.0 * s * k * o, ai * 8.0 * k * o)
    return ghost_cost < direct_cost


def dcresnet_real_ghost(d_params: Dict[str, torch.Tensor], x: torch.Tensor,
                        y: Optional[torch.Tensor], *, n_classes: int, arch: str,
                        aux_type: str, aux_scalar: float,
                        row_w: Optional[torch.Tensor], max_norm,
                        per_layer: bool = False, stride: int = 2, pad: int = 2,
                        compute_dtype=None):
    """Clipped summed gradient of the per-sample REAL wgan loss
    loss_i = -out_i [+ ACGAN aux term of sample i].

    Returns (summed grads by param name, ClipStats in JAX leaf order,
    (out, aux_out))."""
    if arch != "ACGAN":
        raise NotImplementedError(f"conv ghost clipping for {arch} is not ported yet")
    b = x.shape[0]
    dt = compute_dtype
    n_convs = sum(1 for k in d_params if k.startswith("TorchConv_") and k.endswith(".weight"))
    conv_names = [f"TorchConv_{i}" for i in range(n_convs)]
    has_aux = "linOutAux.weight" in d_params

    # ---- forward (DCResNetDiscriminator.forward) ----
    o = x if dt is None else x.to(dt)
    acts = []
    for name in conv_names:
        z = conv_nhwc(o, d_params[f"{name}.weight"], d_params[f"{name}.bias"], stride, pad, dt)
        acts.append((o, z))
        o = torch.where(z >= 0, z, z * 0.2)
    flat = o.reshape(b, -1)
    flat32 = flat.float()
    aux_out = None
    if has_aux:
        aux_out = dense(flat, d_params["linOutAux.weight"], d_params["linOutAux.bias"], dt)
    out = dense(flat, d_params["linOut.weight"], None, dt)

    # ---- head cotangents (d per-sample loss / d pre-activation) ----
    c_out = -torch.ones_like(out)
    c_aux = None
    if has_aux:
        onehot = one_hot(y, n_classes)
        if aux_type == "cross_entropy":
            c_aux = aux_scalar * (torch.softmax(aux_out, dim=-1) - onehot)
        else:   # class-balanced +-sigmoid sum (models/losses.py aux_loss)
            w_row = row_w if row_w is not None else torch.ones(b, device=x.device)
            sig = torch.sigmoid(aux_out)
            c_aux = aux_scalar * w_row[:, None] * (onehot * -2.0 + 1.0) * sig * (1.0 - sig)
    c_flat = c_out @ d_params["linOut.weight"]
    if c_aux is not None:
        c_flat = c_flat + c_aux @ d_params["linOutAux.weight"]

    # ---- input cotangents back through the conv stack ----
    c_a = c_flat.reshape(o.shape)
    if dt is not None:
        c_a = c_a.to(dt)
    cots = [None] * n_convs
    for li in reversed(range(n_convs)):
        a_prev, z = acts[li]
        c_z = c_a * torch.where(z >= 0, 1.0, 0.2).to(c_a.dtype)
        cots[li] = c_z.contiguous()
        if li > 0:
            w = d_params[f"{conv_names[li]}.weight"]
            w = w if dt is None else w.to(dt)
            c_a = torch.nn.grad.conv2d_input(
                a_prev.permute(0, 3, 1, 2).shape, w, c_z.permute(0, 3, 1, 2),
                stride, pad).permute(0, 2, 3, 1)

    # ---- per-sample per-leaf squared norms and weighted-sum closures ----
    sq, wsum = {}, {}
    for li, name in enumerate(conv_names):
        a_prev, c_z = acts[li][0].contiguous(), cots[li]
        cout, cin, kh, kw = d_params[f"{name}.weight"].shape
        kshape = (kh, kw, cin, cout)
        s_sp = c_z.shape[1] * c_z.shape[2]
        if _ghost_order(s_sp, kh * kw * cin, cout):
            sq[f"{name}.weight"] = pcg.ghost_sq_norms(a_prev, c_z, kh, kw, stride, pad)
            kern = lambda f, a=a_prev, c=c_z, ks=kshape: pcg.weighted_kernel_grad(  # noqa: E731
                a, c, f, ks, stride, pad)
        else:
            u = pcg.patches(a_prev, kh, kw, stride, pad)             # [B, S, K]
            c3 = c_z.float().reshape(b, s_sp, cout)
            sq[f"{name}.weight"] = torch.einsum("bsk,bso->bko", u, c3).square().sum(dim=(1, 2))

            def kern(f, u=u, c_z=c_z, ks=kshape):
                cw = (c_z.float() * f[:, None, None, None]).to(c_z.dtype).float()
                return torch.einsum("bsk,bso->ko", u, cw.reshape(b, -1, ks[3])).reshape(ks)
        wsum[f"{name}.weight"] = lambda f, kern=kern: kern(f).permute(3, 2, 0, 1).contiguous()
        g_b = c_z.float().sum(dim=(1, 2))                              # [B, O]
        sq[f"{name}.bias"] = g_b.square().sum(dim=1)
        wsum[f"{name}.bias"] = lambda f, g_b=g_b: (g_b * f[:, None]).sum(dim=0)

    sq_flat = flat32.square().sum(dim=1)
    sq["linOut.weight"] = sq_flat * c_out.square().sum(dim=1)
    wsum["linOut.weight"] = lambda f: torch.einsum("bi,bo->oi", flat32 * f[:, None], c_out)
    leaves = [k for n in conv_names for k in (f"{n}.bias", f"{n}.weight")] + ["linOut.weight"]
    if c_aux is not None:
        sq_ca = c_aux.square().sum(dim=1)
        sq["linOutAux.bias"] = sq_ca
        sq["linOutAux.weight"] = sq_flat * sq_ca
        wsum["linOutAux.bias"] = lambda f: (c_aux * f[:, None]).sum(dim=0)
        wsum["linOutAux.weight"] = lambda f: torch.einsum("bi,bo->oi", flat32 * f[:, None], c_aux)
        leaves += ["linOutAux.bias", "linOutAux.weight"]

    leaf_norms = torch.stack([torch.sqrt(torch.clamp(sq[k], min=0.0)) for k in leaves])
    clip_norms = leaf_norms * _BF16_NORM_MARGIN if dt is not None else leaf_norms
    factors = clip_factors(clip_norms, max_norm, per_layer)
    summed = {k: wsum[k](factors[i]) for i, k in enumerate(leaves)}
    return summed, stats_from_norms(leaf_norms, factors), (out, aux_out)
