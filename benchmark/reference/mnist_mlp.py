"""Plain reference of the MNIST conditional ACGAN MLP pair trained under gc.

The published models (twosixlabs/csl-gan ``MNIST_models.py``): G maps z
(100) and the one-hot label (10) through 128 ReLU units to 784 sigmoid
pixels; D maps the 784 pixels and the one-hot label through 128 ReLU units
to a real/fake logit and 10 class logits. Weights are in torch layout
([out, in]) under the state-dict names the configuration file lists.

One training step, as the configuration states it: a G forward for the
fakes on the real batch's labels; the private real pass, one gradient per
sample of BCE(out, 1) + CE(aux, y), each clipped to a flat L2 norm C; the
clean fake pass, the summed gradient of BCE(out, 0) + CE(aux, y); the DP
noise added to the sum; the sum divided by the batch; Adam on D. Then the G
step against the updated D: mean BCE(out, 1) + mean CE(aux, y_g); Adam on G.
All in fp32 with TF32 off, or with the operands rounded as ``prec`` says.

``steps(inputs)`` replays the first steps of an epoch from the stream's
seeds and the data files, as the configuration's ``stream`` says the
program draws them, and returns what the harness compares.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import common
from .common import Params, Stream, adam, bce_with_logits, cross_entropy, onehot, operand


def _lin(x, w, b, prec):
    return operand(x, prec) @ operand(w, prec).T + b


def g_forward(p: Params, z, y_oh, prec: str = "fp32"):
    h = torch.relu(_lin(torch.cat([z, y_oh], dim=1), p["lin1.weight"], p["lin1.bias"], prec))
    return torch.sigmoid(_lin(h, p["lin2.weight"], p["lin2.bias"], prec))


def d_forward(p: Params, x, y_oh, prec: str = "fp32"):
    h = torch.relu(_lin(torch.cat([x, y_oh], dim=1), p["lin1.weight"], p["lin1.bias"], prec))
    return (_lin(h, p["lin2.weight"], p["lin2.bias"], prec)[:, 0],
            _lin(h, p["linOutAux.weight"], p["linOutAux.bias"], prec))


def d_step(cfg: dict, p_d: Params, p_g: Params, x, y, z, noise: Dict[str, torch.Tensor],
           prec: str, keep=None):
    """One D step; returns (grads, metrics). ``keep`` (a [B] 0/1 mask)
    plants the half-batch fault: only kept rows count, the mean over them."""
    nc, a_s, clip = cfg["n_classes"], cfg["aux_loss_scalar"], cfg["clipping_param"]
    y_oh = onehot(y, nc)
    with torch.no_grad():
        fake = g_forward(p_g, z, y_oh, prec)
    if keep is not None:
        idx = torch.nonzero(keep).flatten()
        x, y, y_oh, fake = x[idx], y[idx], y_oh[idx], fake[idx]
    b = x.shape[0]

    def loss_one(p, xi, yi_oh, yi):
        out, aux = d_forward(p, xi[None], yi_oh[None], prec)
        return bce_with_logits(out, 1.0).sum() + a_s * cross_entropy(aux, yi[None]).sum()

    summed = common.clipped_sum(loss_one, p_d, (x, y_oh, y), clip, chunk=b)
    p = {k: v.detach().requires_grad_(True) for k, v in p_d.items()}
    with torch.enable_grad():
        out_f, aux_f = d_forward(p, fake, y_oh, prec)
        loss = bce_with_logits(out_f, 0.0).sum() + a_s * cross_entropy(aux_f, y).sum()
        fake_g = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    grads = {k: (summed[k] + noise[k] + fake_g[k]) / b for k in p_d}
    with torch.no_grad():
        out_r, aux_r = d_forward(p_d, x, y_oh, prec)
    m = {"d_real_loss": float(bce_with_logits(out_r, 1.0).mean()),
         "d_fake_loss": float(bce_with_logits(out_f.detach(), 0.0).mean()),
         "d_real_aux_loss": float(a_s * cross_entropy(aux_r, y).mean())}
    return grads, m


def g_step(cfg: dict, p_d: Params, p_g: Params, z, y, prec: str):
    nc, a_s = cfg["n_classes"], cfg["aux_loss_scalar"]
    y_oh = onehot(y, nc)
    p = {k: v.detach().requires_grad_(True) for k, v in p_g.items()}
    with torch.enable_grad():
        out, aux = d_forward(p_d, g_forward(p, z, y_oh, prec), y_oh, prec)
        adv = bce_with_logits(out, 1.0).mean()
        aux_l = a_s * cross_entropy(aux, y).mean()
        grads = dict(zip(p, torch.autograd.grad(adv + aux_l, list(p.values()))))
    return grads, {"g_adv_loss": float(adv.detach()), "g_aux_loss": float(aux_l.detach())}


def load_table(files: dict, cfg: dict) -> tuple:
    """(x [N, 784] fp32 as the table stores it, labels [N]) of the training
    set: the IDX files, the first tss / n_classes rows of each class in file
    order, pixels / 255 rounded to the table's dtype."""
    def idx(path):
        with open(path, "rb") as f:
            raw = f.read()
        ndim = raw[3]
        dims = [int.from_bytes(raw[4 + 4 * i:8 + 4 * i], "big") for i in range(ndim)]
        return np.frombuffer(raw, np.uint8, offset=4 + 4 * ndim).reshape(dims)

    images, labels = idx(files["images"]), idx(files["labels"]).astype(np.int64)
    per = cfg["train_set_size"] // cfg["n_classes"]
    keep = np.concatenate([np.nonzero(labels == c)[0][:per] for c in range(cfg["n_classes"])])
    x = torch.from_numpy(images[keep].reshape(len(keep), -1).astype(np.float32)) / 255.0
    x = x.to(getattr(torch, cfg["table_dtype"])).float()
    return x, torch.from_numpy(labels[keep])


def steps(inputs: dict, segments=(1, 1, 1), prec: str = "fp32", fault: str = None) -> dict:
    """The first steps of epoch 0 as the program runs them from ``inputs``
    (device, seeds, initial params ``d0`` / ``g0``, data files, config), in
    ``segments``: the step counts of consecutive K1 launches, each of which
    draws its steps' inputs at once, in the order the configuration's
    ``stream`` states. Returns {"losses": [{name: mean over the segment's
    steps}], "grad1": {leaf: tensor}, "params": {leaf: tensor after the
    last step}} with D leaves as ``d:<name>`` and G leaves as ``g:<name>``.
    ``fault`` plants a fault in this reference put in the program's place:
    "half_batch"."""
    cfg, dev = inputs["config"], torch.device(inputs["device"])
    bs, lat, nc = inputs["batch_size"], cfg["latent"], cfg["n_classes"]
    x_all, y_all = load_table(inputs["files"], cfg)
    x_all, y_all = x_all.to(dev), y_all.to(dev)
    perm = Stream(inputs["perm_seed"], dev).randperm(x_all.shape[0])
    st = Stream(inputs["step_seed"], dev)
    p_d = {k: v.to(dev) for k, v in inputs["d0"].items()}
    p_g = {k: v.to(dev) for k, v in inputs["g0"].items()}
    m_d, v_d, m_g, v_g = (common.zeros_like(p) for p in (p_d, p_d, p_g, p_g))
    std = common.fp32_product(cfg["sigma"], cfg["clipping_param"])
    d_order = cfg["stream"]["d_leaves"]
    b1, b2 = cfg["adam_b1"], cfg["adam_b2"]
    out, per_step, s = {"grad1": {}}, [], 0
    for n in segments:
        # One K1 launch of n steps: z_d, z_g, y_g, then the noise leaves.
        z_d = st.randn((n, bs, lat))
        z_g = st.randn((n, bs, lat))
        y_g = st.randint(nc, (n, bs))
        noise = dict(zip(d_order, common.leaf_noise(
            st, [tuple(p_d[k].shape) for k in d_order], std, lead=(n,))))
        for j in range(n):
            idx = perm[s * bs:(s + 1) * bs]
            x, y = x_all[idx], y_all[idx]
            keep = None
            if fault == "half_batch":
                keep = (torch.arange(bs, device=dev) < bs // 2).float()
            gd, md = d_step(cfg, p_d, p_g, x, y, z_d[j], {k: v[j] for k, v in noise.items()},
                            prec, keep)
            p_d, m_d, v_d = adam(p_d, gd, m_d, v_d, s + 1, cfg["d_lr"], b1, b2)
            gg, mg = g_step(cfg, p_d, p_g, z_g[j], y_g[j], prec)
            p_g, m_g, v_g = adam(p_g, gg, m_g, v_g, s + 1, cfg["g_lr"], b1, b2)
            per_step.append({**md, **mg})
            if s == 0:
                out["grad1"] = {**{f"d:{k}": v for k, v in gd.items()},
                                **{f"g:{k}": v for k, v in gg.items()}}
            s += 1
    out["losses"] = common.segment_means(per_step, segments)
    out["params"] = {**{f"d:{k}": v for k, v in p_d.items()},
                     **{f"g:{k}": v for k, v in p_g.items()}}
    return out


def model_flops_per_sample(cfg: dict) -> dict:
    """Forward FLOPs a sample of D and of G, from the widths (2 per
    multiply-add)."""
    f, nc, h, lat = 784, cfg["n_classes"], 128, cfg["latent"]
    d = 2 * h * (f + nc) + 2 * h * (1 + nc)
    g = 2 * h * (lat + nc) + 2 * f * h
    return {"d_forward": float(d), "g_forward": float(g)}

