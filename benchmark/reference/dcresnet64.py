"""Plain reference of the CelebA 64x64 conditional ACGAN DCResNet pair
trained under gc with WGAN-GP on mean samples.

The published models (twosixlabs/csl-gan ``DCResNet_models.py``): G maps z
(128) and the one-hot label (2) by a dense layer to 4 x 4 x 512, then four
upsampling residual blocks (512 -> 512 -> 256 -> 128 -> 64 channels; each:
the shortcut, a 2x nearest upsample and a 1x1 conv, beside GroupNorm(32) +
ReLU, upsample, 5x5 conv without bias, GroupNorm(32) + ReLU, 5x5 conv), a
last GroupNorm(32) + ReLU, a 3x3 conv to 3 channels and tanh. D: four 5x5
stride-2 convs (3 -> 64 -> 128 -> 256 -> 512) with leaky ReLU(0.2), the
flattened 4 x 4 x 512 (in H, W, C order) to a critic (no bias) and 2 class
logits. Weights in torch layout under the state-dict names the
configuration lists.

bf16 rules, as the configuration states them: convs take bf16 inputs,
weights and bias and give bf16 outputs; dense layers take bf16-rounded
operands with an fp32 product and output; GroupNorm's statistics are fp32
and its output is in its input's dtype; tanh is fp32. Under "fp8" every
product's operands are first quantized to float8 e4m3 (per-tensor scale).

One D step: the fakes G(z, y) on the real batch's labels; the private real
pass, per-sample gradients of -out_i + the class-balanced Wasserstein aux
term, clipped to a flat norm C (the ghost route's norms carry the stated
bf16 margin); the fake pass, the summed gradient of out_i + the aux term;
WGAN-GP (weight 10) on interpolates of mean-sample surrogates and the
fakes, over the critic and each class logit, times the batch; the DP noise;
the sum over the batch; Adam. The G step (on the n_d_steps cadence) against
the updated D: -mean(out) + the aux term.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from . import common, philox
from .common import Params, Stream, adam, compute_dtype, onehot, operand


def conv(x, w, b, stride: int, pad: int, prec: str):
    x, w = operand(x, prec), operand(w, prec)
    dt = compute_dtype(prec)
    if dt is not None:
        x, w = x.to(dt), w.to(dt)
        b = None if b is None else b.to(dt)
    return F.conv2d(x, w, b, stride, pad)


def dense(x, w, b, prec: str):
    x, w = operand(x, prec), operand(w, prec)
    if compute_dtype(prec) is not None:
        x, w = x.to(torch.bfloat16).float(), w.to(torch.bfloat16).float()
    y = x.float() @ w.float().T
    return y if b is None else y + b


def gn_relu(x, gamma, beta):
    return torch.relu(F.group_norm(x.float(), 32, gamma, beta, 1e-5)).to(x.dtype)


def up(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def g_forward(p: Params, z, y, nc: int, prec: str):
    """Images [B, 64, 64, 3] (NHWC) in fp32."""
    x = dense(torch.cat([z, onehot(y, nc)], dim=1), p["TorchDense_0.weight"],
              p["TorchDense_0.bias"], prec)
    x = x.view(z.shape[0], 4, 4, -1).permute(0, 3, 1, 2)
    for i in range(4):
        r = f"ResBlockUp_{i}."
        s = conv(up(x), p[r + "UpsampleConv_0.TorchConv_0.weight"],
                 p[r + "UpsampleConv_0.TorchConv_0.bias"], 1, 0, prec)
        o = gn_relu(x, p[r + "GroupNorm_0.weight"], p[r + "GroupNorm_0.bias"])
        o = conv(up(o), p[r + "UpsampleConv_1.TorchConv_0.weight"], None, 1, 2, prec)
        o = gn_relu(o, p[r + "GroupNorm_1.weight"], p[r + "GroupNorm_1.bias"])
        x = conv(o, p[r + "TorchConv_0.weight"], p[r + "TorchConv_0.bias"], 1, 2, prec) + s
    x = gn_relu(x, p["GroupNorm_0.weight"], p["GroupNorm_0.bias"])
    x = conv(x, p["TorchConv_0.weight"], p["TorchConv_0.bias"], 1, 1, prec)
    return torch.tanh(x.float()).permute(0, 2, 3, 1)


def d_forward(p: Params, x, prec: str):
    """(critic [B], class logits [B, 2]) of NHWC images."""
    o = x.permute(0, 3, 1, 2)
    for i in range(4):
        o = F.leaky_relu(conv(o, p[f"TorchConv_{i}.weight"], p[f"TorchConv_{i}.bias"], 2, 2,
                              prec), 0.2)
    flat = o.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return (dense(flat, p["linOut.weight"], None, prec)[:, 0],
            dense(flat, p["linOutAux.weight"], p["linOutAux.bias"], prec))


def aux_terms(aux, y, row_w, nc: int, scalar: float):
    """The class-balanced Wasserstein aux loss of each row:
    scalar * row_w_i * sum_c (1 - 2 onehot_ic) sigmoid(aux_ic)."""
    sign = 1.0 - 2.0 * onehot(y, nc)
    return scalar * row_w * (sign * torch.sigmoid(aux.float())).sum(dim=1)


def class_weights(y, nc: int):
    """1 / (the count of each row's class in the batch)."""
    oh = onehot(y, nc)
    return 1.0 / torch.clamp(oh @ oh.sum(dim=0), min=1.0)


def penalty(p: Params, interp, nc: int, prec: str, weight: float):
    """WGAN-GP: weight * mean_i sum over the critic and each class logit of
    (||d head_i / d x_i|| - 1)^2, as a function of p."""
    xi = interp.detach().requires_grad_(True)
    out, aux = d_forward(p, xi, prec)
    heads = [out] + [aux[:, c] for c in range(nc)]
    total = 0.0
    for h in heads:
        g, = torch.autograd.grad(h.float().sum(), xi, create_graph=True)
        n = torch.sqrt(g.reshape(g.shape[0], -1).float().square().sum(dim=1) + 1e-12)
        total = total + (n - 1.0) ** 2
    return weight * total.mean()


def d_step(cfg: dict, route: dict, p_d: Params, p_g: Params, x, y, z, noise: Params,
           pen_x, alpha, prec: str, keep=None):
    nc, a_s, clip = cfg["n_classes"], cfg["aux_loss_scalar"], cfg["clipping_param"]
    with torch.no_grad():
        fake = g_forward(p_g, z, y, nc, prec)
    if keep is not None:
        idx = torch.nonzero(keep).flatten()
        x, y, z, fake, pen_x, alpha = (t[idx] for t in (x, y, z, fake, pen_x, alpha))
    b = x.shape[0]
    row_w = class_weights(y, nc)

    def loss_one(p, xi, yi, wi):
        out, aux = d_forward(p, xi[None], prec)
        return (-out.float() + aux_terms(aux, yi[None], wi[None], nc, a_s)).sum()

    margin = route.get("bf16_norm_margin", 1.0) if compute_dtype(prec) is not None else 1.0
    summed = common.clipped_sum(loss_one, p_d, (x, y, row_w), clip,
                                chunk=cfg["reference_chunk"], norm_margin=margin)
    p = {k: v.detach().requires_grad_(True) for k, v in p_d.items()}
    with torch.enable_grad():
        out_f, aux_f = d_forward(p, fake, prec)
        loss_f = (out_f.float() + aux_terms(aux_f, y, row_w, nc, a_s)).sum()
        fake_g = torch.autograd.grad(loss_f, list(p.values()))
        interp = alpha * pen_x + (1.0 - alpha) * fake
        pen = penalty(p, interp, nc, prec, cfg["gp_weight"])
        pen_g = torch.autograd.grad(pen, list(p.values()), allow_unused=True)
    grads = {}
    for i, k in enumerate(p_d):
        pg = torch.zeros_like(p_d[k]) if pen_g[i] is None else pen_g[i]
        grads[k] = (summed[k] + noise[k] + fake_g[i] + b * pg) / b
    with torch.no_grad():
        out_r, aux_r = d_forward(p_d, x, prec)
    m = {"d_real_loss": float(-out_r.float().mean()),
         "d_fake_loss": float(out_f.detach().float().mean()),
         "d_real_aux_loss": float(aux_terms(aux_r, y, row_w, nc, a_s).sum()),
         "penalty": float(pen.detach())}
    return grads, m


def g_step(cfg: dict, p_d: Params, p_g: Params, z, y, prec: str):
    nc, a_s = cfg["n_classes"], cfg["aux_loss_scalar"]
    p = {k: v.detach().requires_grad_(True) for k, v in p_g.items()}
    with torch.enable_grad():
        out, aux = d_forward(p_d, g_forward(p, z, y, nc, prec), prec)
        adv = -out.float().mean()
        aux_l = aux_terms(aux, y, class_weights(y, nc), nc, a_s).sum()
        grads = dict(zip(p, torch.autograd.grad(adv + aux_l, list(p.values()))))
    return grads, {"g_adv_loss": float(adv.detach()), "g_aux_loss": float(aux_l.detach())}


def load_data(files: dict, cfg: dict):
    """(uint8 images [N, 64, 64, 3] memory-mapped, labels [N]) of the first
    train_set_size rows: the decoded image file and the attribute file's
    column."""
    images = np.load(files["images"], mmap_mode="r")[:cfg["train_set_size"]]
    with open(files["attributes"]) as f:
        next(f)
        names = next(f).split()
        col = names.index(cfg["label_attr"])
        labels = [int(line.split()[1 + col]) == 1 for _, line in
                  zip(range(cfg["train_set_size"]), f)]
    return images, np.asarray(labels, np.int64)


def mean_samples(images, labels, cfg: dict, manual_seed: int) -> np.ndarray:
    """The privatized class means [n_classes, num, 64, 64, 3] (fp32), drawn
    as the configuration's stream states: each is the mean of the first
    mean_sample_size rows of its class among a batch of mean_sample_size *
    n_classes rows (an arange shuffled by default_rng(seed + loader), pixels
    / 127.5 - 1, flipped where default_rng(seed + flip).random() < 0.5) plus
    N(0, noise_std) from default_rng(seed + noise)."""
    ms = cfg["stream"]["mean_samples"]
    nc, size, num = cfg["n_classes"], cfg["mean_sample_size"], cfg["num_mean_samples"]
    order_rng = np.random.default_rng(manual_seed + ms["loader_seed_offset"])
    flip_rng = np.random.default_rng(manual_seed + ms["flip_seed_offset"])
    noise_rng = np.random.default_rng(manual_seed + ms["noise_seed_offset"])
    out = [[] for _ in range(nc)]
    for _ in range(num):
        idx = np.arange(len(images))
        order_rng.shuffle(idx)
        idx = idx[:size * nc]
        x = np.asarray(images[idx], np.float32) / 127.5 - 1.0
        fl = flip_rng.random(len(x)) < 0.5
        x[fl] = x[fl, :, ::-1, :]
        lab = labels[idx]
        for c in range(nc):
            s = x[lab == c][:size].sum(axis=0) / size
            out[c].append((s + noise_rng.normal(0, cfg["mean_sample_noise_std"],
                                                size=s.shape)).astype(np.float32))
    return np.stack([np.stack(s) for s in out])


def step_noise(st: Stream, route: dict, shapes: Dict[str, tuple], order: List[str],
               std: float, device) -> Params:
    """One step's DP noise by the route's stated stream: a normal draw per
    leaf in leaf order ("per_leaf"), or ("counter") one int64 seed per leaf,
    counter-based Philox normals for leaves of at least ``large`` elements
    and one shared normal draw for the others."""
    if route["noise"] == "per_leaf":
        return dict(zip(order, common.leaf_noise(st, [shapes[k] for k in order], std)))
    seeds = st.randint(2 ** 63 - 1, (len(order),)).tolist()
    numel = {k: int(np.prod(shapes[k])) for k in order}
    small = [k for k in order if numel[k] < route["large"]]
    flat = st.randn((sum(numel[k] for k in small),))
    out, off = {}, 0
    for k, seed in zip(order, seeds):
        if k in small:
            out[k] = flat[off:off + numel[k]].reshape(shapes[k]) * std
            off += numel[k]
        else:
            out[k] = (philox.normals(seed, numel[k], device) * std).reshape(shapes[k])
    return out


def steps(inputs: dict, segments=(1, 1, 1), prec: str = None, fault: str = None) -> dict:
    """The first D steps of epoch 0 (with the G step on the cadence) from
    ``inputs``, in ``segments`` (the step runner draws each step's inputs as
    it comes, whatever the segments); see mnist_mlp.steps for what it
    returns."""
    cfg, dev = inputs["config"], torch.device(inputs["device"])
    route = inputs["route"]
    prec = prec or cfg["precision"]
    bs, lat, nc = inputs["batch_size"], cfg["latent"], cfg["n_classes"]
    images, labels = load_data(inputs["files"], cfg)
    p1 = float(labels.sum()) / len(labels)
    means = torch.from_numpy(mean_samples(images, labels, cfg, inputs["manual_seed"])).to(dev)
    perm = Stream(inputs["perm_seed"], dev).randperm(len(images))
    st = Stream(inputs["step_seed"], dev)
    p_d = {k: v.to(dev) for k, v in inputs["d0"].items()}
    p_g = {k: v.to(dev) for k, v in inputs["g0"].items()}
    m_d, v_d, m_g, v_g = (common.zeros_like(p) for p in (p_d, p_d, p_g, p_g))
    order = cfg["stream"]["d_leaves"]
    shapes = {k: tuple(v.shape) for k, v in p_d.items()}
    std = common.fp32_product(cfg["sigma"], cfg["clipping_param"])
    b1, b2 = cfg["adam_b1"], cfg["adam_b2"]
    out, per_step = {"grad1": {}}, []
    g_count = 0
    for s in range(sum(segments)):
        idx = perm[s * bs:(s + 1) * bs].cpu().numpy()
        x = torch.from_numpy(np.asarray(images[idx])).to(dev).float() / 127.5 - 1.0
        y = torch.from_numpy(labels[idx]).to(dev)
        flip = st.rand((bs,)) < 0.5
        x = torch.where(flip[:, None, None, None], x.flip(2), x)
        z = st.randn((bs, lat))
        noise = step_noise(st, route, shapes, order, std, dev)
        pick = st.randint(cfg["num_mean_samples"], (bs,))
        n_mean = st.randn((bs, 1, 1, 1))
        n_pix = st.randn((bs,) + tuple(means.shape[2:]))
        pen_x = means[y, pick] + 0.01 * n_mean + 0.01 * n_pix
        alpha = st.rand((bs, 1, 1, 1))
        keep = None
        if fault == "half_batch":
            keep = (torch.arange(bs, device=dev) < bs // 2).float()
        gd, md = d_step(cfg, route, p_d, p_g, x, y, z, noise, pen_x, alpha, prec, keep)
        p_d, m_d, v_d = adam(p_d, gd, m_d, v_d, s + 1, cfg["d_lr"], b1, b2)
        losses = dict(md)
        if s % cfg["n_d_steps"] == 0:
            z_g = st.randn((bs, lat))
            y_g = (st.rand((bs,)) < p1).long()
            gg, mg = g_step(cfg, p_d, p_g, z_g, y_g, prec)
            g_count += 1
            p_g, m_g, v_g = adam(p_g, gg, m_g, v_g, g_count, cfg["g_lr"], b1, b2)
            losses.update(mg)
            if s == 0:
                out["grad1"].update({f"g:{k}": v for k, v in gg.items()})
        if s == 0:
            out["grad1"].update({f"d:{k}": v for k, v in gd.items()})
        per_step.append(losses)
    out["losses"] = common.segment_means(per_step, segments)
    out["params"] = {**{f"d:{k}": v for k, v in p_d.items()},
                     **{f"g:{k}": v for k, v in p_g.items()}}
    return out
