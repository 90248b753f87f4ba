"""Train-step math of the ported conditional ACGAN gc paths, in PyTorch.

The port's counterparts of the JAX package's training/steps.py pieces:

- MNIST vanilla (the steps the whole-epoch kernel K1 mirrors): the gc D step
  (ghost-clipped real pass plus the clean fake pass ``fake_sum``, JAX
  ``_d_step_gc``), the non-private D step and the G step (``_g_step``). They
  are the plain version of K1 (ops/pallas_epoch.py ``epoch_plain``).
- DCResNet (``d_step_conv_ghost``, ``g_step_dcresnet``): the gc D step's
  conv-ghost branch (ops/conv_ghost.py, K2/K3) with the clean fake pass, the
  WGAN-GP penalty on mean samples scaled by the batch size, the noise and
  Adam; the G step through the K4/K5 GroupNorm+ReLU layers.
- optax's Adam.

All randomness is an explicit input (z, labels, per-leaf DP noise, penalty
interpolation weights, mean-sample surrogates), so the same inputs give the
same values in both packages. Parameters are dicts of torch state-dict names;
per-leaf lists follow the JAX leaf order (``StepBuilder.d_leaves``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional

import torch
from torch.func import functional_call

from csl_gan_tpu_torch.models import losses
from csl_gan_tpu_torch.models.dcresnet import DCResNetDiscriminator, d_leaves
from csl_gan_tpu_torch.models.mnist import D_LEAVES, G_LEAVES, MNISTVanillaD
from csl_gan_tpu_torch.ops import conv_ghost, ghost
from csl_gan_tpu_torch.training import penalty as penalty_mod

Params = Dict[str, torch.Tensor]


@dataclass
class TrainState:
    d_params: Params
    g_params: Params
    d_mu: Params
    d_nu: Params
    g_mu: Params
    g_nu: Params
    d_count: int          # optax ScaleByAdamState.count of D
    g_count: int
    clipping: float


def adam_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, t: int, lr: float, b1: float, b2: float,
                eps: float = 1e-8):
    """optax scale_by_adam (eps_root=0) + scale(-lr) + apply_updates, with the
    bias correction 1 - exp(t * ln b) in fp32 as K1 computes it
    (JAX ops/pallas_epoch.py:172-182). Returns (p, m, v)."""
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    tt = torch.tensor(float(t), dtype=torch.float32, device=p.device)

    def bias_correction(b):       # 1 - b**t; 0**t = 0 for t >= 1 (b1 = 0)
        return 1.0 if b == 0.0 else 1.0 - torch.exp(tt * math.log(b))

    u = (m / bias_correction(b1)) / (torch.sqrt(v / bias_correction(b2)) + eps)
    return p - lr * u, m, v


def _adam_all(params: Params, grads: Params, mu: Params, nu: Params, t: int,
              lr: float, b1: float, b2: float):
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        new_p[k], new_m[k], new_v[k] = adam_update(
            params[k], grads[k], mu[k], nu[k], t, lr, b1, b2)
    return new_p, new_m, new_v


def _acc_vs_max(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """argmax(logits) == label, computed as "the true label's logit attains
    the row max" (K1's form; identical off exact ties)."""
    true_logit = torch.sum(onehot * logits, dim=1)
    return (true_logit >= logits.amax(dim=1)).to(torch.float32)


class StepBuilder:
    """Config of the ported step functions (the JAX TrainStepBuilder's
    fields that the epoch kernel's gate reads) plus the step math."""

    def __init__(self, opt, G, D, label1_prob: float = 0.5):
        self.opt = opt
        self.G, self.D = G, D
        self.family = G.family
        self.conditional = bool(opt.conditional)
        self.n_classes = opt.n_classes if opt.conditional else 0
        self.arch = opt.conditional_arch
        self.aux_type = opt.aux_loss_type
        self.aux_scalar = float(opt.aux_loss_scalar)
        self.use_aux = bool(opt.use_aux_loss)
        self.d_fake_aux = bool(opt.d_fake_aux_loss)
        self.latent = opt.g_latent_dim
        self.sigma = opt.sigma
        self.dp_mode = opt.dp_mode
        self.per_layer = bool(opt.use_grad_clip_per_layer)
        self.adaptive = (opt.grad_clip_mode or "standard").startswith("adaptive")
        self.poisson = bool(opt.poisson)
        self.penalty_types = list(opt.penalty or [])
        self.use_bpc = bool(opt.backprop_clip)
        self.chunk = opt.per_sample_chunk
        self.is_acgan = bool(opt.is_acgan)
        self.aux_penalty = bool(opt.aux_penalty)
        # Bernoulli(label1_prob) labels for two classes (the CelebA label
        # frequency; the JAX package's gen_y).
        self.label1_prob = label1_prob
        self.g_has_bn = False
        self.use_ghost = (isinstance(D, MNISTVanillaD) and self.dp_mode == "gc"
                          and bool(opt.grad_clip_split) and not self.use_bpc
                          and self.chunk is None)
        # DCResNet D: conv ghost clipping (ops/conv_ghost.py) for the private
        # real pass, bf16 compute under --bf16.
        dcresnet = isinstance(D, DCResNetDiscriminator)
        self.use_conv_ghost = (dcresnet and self.dp_mode == "gc"
                               and bool(opt.grad_clip_split)
                               and bool(opt.conv_ghost) and not self.use_bpc
                               and self.chunk is None)
        self.compute_dtype = torch.bfloat16 if dcresnet and opt.bf16 else None
        self.d_leaves = tuple(d_leaves(D)) if dcresnet else D_LEAVES
        self.g_leaves = tuple(G.state_dict()) if dcresnet else G_LEAVES
        self.img_shape = (28, 28, 1)
        # Set by the Trainer when the device table is [x | one-hot | label].
        self.labels_in_table = False
        self.onehot_in_table = False

    # ---------------- state and randomness ----------------

    def init_state(self) -> TrainState:
        d = {k: v.detach().clone() for k, v in self.D.state_dict().items()}
        g = {k: v.detach().clone() for k, v in self.G.state_dict().items()}
        d = {k: d[k] for k in self.d_leaves}
        g = {k: g[k] for k in self.g_leaves}
        zeros = lambda t: {k: torch.zeros_like(v) for k, v in t.items()}  # noqa: E731
        return TrainState(d, g, zeros(d), zeros(d), zeros(g), zeros(g), 0, 0,
                          float(self.opt.clipping_param or 1.0))

    def gen_z(self, gen: torch.Generator, size: int, lead: tuple = ()):
        return torch.randn(lead + (size, self.latent), generator=gen,
                           device=gen.device, dtype=torch.float32)

    def gen_y(self, gen: torch.Generator, size: int, lead: tuple = ()):
        """Class labels (reference train.py:153-161): Bernoulli(label1_prob)
        for two classes, uniform otherwise (the JAX package's gen_y)."""
        if self.n_classes == 2:
            u = torch.rand(lead + (size,), generator=gen, device=gen.device)
            return (u < self.label1_prob).to(torch.int64)
        return torch.randint(0, self.n_classes, lead + (size,), generator=gen,
                             device=gen.device)

    def gather_batch(self, table: torch.Tensor, idx: torch.Tensor):
        """(x [B,28,28,1] f32, y [B] int64, one-hot [B, nc] f32) from the
        flat [x | one-hot | label] table; rows convert to fp32 right after the
        gather, so all training arithmetic runs on the stored values."""
        return self.split_rows(table[idx])

    def split_rows(self, rows: torch.Tensor):
        rows = rows.to(torch.float32)
        f = 1
        for d in self.img_shape:
            f *= d
        x = rows[:, :f].reshape((rows.shape[0],) + tuple(self.img_shape))
        onehot = rows[:, f:f + self.n_classes]
        return x, rows[:, -1].to(torch.int64), onehot

    # ---------------- D steps ----------------

    def _fake_sum_grads(self, d_params: Params, fake: torch.Tensor,
                        y: torch.Tensor):
        """Summed grads of the clean fake pass (JAX steps.py fake_sum):
        sum_i BCE(out_i, 0) [+ aux_scalar * CE_i when d_fake_aux]."""
        p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        with torch.enable_grad():
            out, aux_o = functional_call(self.D, p, (fake, y),
                                         {"aux": self.d_fake_aux})
            loss = losses.d_fake_loss(self.family, out, "sum")
            if self.d_fake_aux and self.use_aux:
                loss = loss + losses.aux_loss(
                    self.arch, self.aux_type, self.aux_scalar, aux_o, y,
                    self.n_classes, reduction="sum")
            grads = torch.autograd.grad(loss, [p[k] for k in self.d_leaves])
        return dict(zip(self.d_leaves, grads)), out.detach()

    def _real_sum_grads(self, d_params: Params, x, y):
        """Plain summed grads of the per-sample real loss (non-private)."""
        p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        with torch.enable_grad():
            out, aux_o = functional_call(self.D, p, (x, y))
            loss = losses.d_real_loss(self.family, out, "sum") + losses.aux_loss(
                self.arch, self.aux_type, self.aux_scalar, aux_o, y,
                self.n_classes, reduction="sum")
            grads = torch.autograd.grad(loss, [p[k] for k in self.d_leaves])
        return dict(zip(self.d_leaves, grads)), out.detach(), aux_o.detach()

    def d_step(self, state: TrainState, x, y, y_onehot, z,
               noise: Optional[List[torch.Tensor]], use_dp: bool):
        """One D update: gc (ghost-clipped real pass + clean fake pass +
        pre-drawn noise, JAX _d_step_gc) or, without DP, plain summed grads;
        then /bs and Adam. Returns (state, metrics)."""
        b = x.shape[0]
        fake = functional_call(self.G, state.g_params, (z, y)).detach()
        stats = None
        if use_dp:
            summed, stats, (r_out, r_aux) = ghost.vanilla_real_ghost(
                state.d_params, x, y_onehot, y, self.aux_scalar,
                state.clipping, self.per_layer)
        else:
            summed, r_out, r_aux = self._real_sum_grads(state.d_params, x, y)
        fake_grads, f_out = self._fake_sum_grads(state.d_params, fake, y)
        inv_b = 1.0 / b
        grads = {}
        for i, k in enumerate(D_LEAVES):
            t = summed[k] + fake_grads[k]
            if use_dp:
                t = t + noise[i]
            grads[k] = t * inv_b
        d_params, d_mu, d_nu = _adam_all(
            state.d_params, grads, state.d_mu, state.d_nu, state.d_count + 1,
            self.opt.d_lr, self.opt.adam_b1, self.opt.adam_b2)

        r_loss = losses.d_real_loss(self.family, r_out)
        f_loss = losses.d_fake_loss(self.family, f_out)
        m = {"d_adv_loss": r_loss + f_loss, "d_real_loss": r_loss,
             "d_fake_loss": f_loss,
             "d_real_acc": 100.0 * (r_out > 0).to(torch.float32).mean(),
             "d_fake_acc": 100.0 * (f_out < 0).to(torch.float32).mean(),
             "d_real_aux_loss": losses.aux_loss(
                 self.arch, self.aux_type, self.aux_scalar, r_aux, y,
                 self.n_classes),
             "d_real_aux_acc": 100.0 * _acc_vs_max(r_aux, y_onehot).mean()}
        if stats is not None:
            m.update(norm_mean=stats.norm_mean, norm_std=stats.norm_std,
                     norm_max=stats.norm_max, frac_clipped=stats.frac_clipped)
        new_state = replace(state, d_params=d_params, d_mu=d_mu, d_nu=d_nu,
                            d_count=state.d_count + 1)
        return new_state, m

    # ---------------- G step ----------------

    def g_step(self, state: TrainState, z, y_onehot):
        """G update against the (already updated) D: mean BCE-vs-ones +
        ACGAN aux CE (JAX _g_step). Returns (state, metrics)."""
        y = torch.argmax(y_onehot, dim=1)
        p = {k: v.detach().requires_grad_(True) for k, v in state.g_params.items()}
        with torch.enable_grad():
            img = functional_call(self.G, p, (z, y))
            out, aux_o = functional_call(self.D, state.d_params, (img, y))
            adv = losses.g_adv_loss(self.family, out)
            aux = losses.aux_loss(self.arch, self.aux_type, self.aux_scalar,
                                  aux_o, y, self.n_classes)
            grads = torch.autograd.grad(adv + aux, [p[k] for k in G_LEAVES])
        grads = dict(zip(G_LEAVES, grads))
        g_params, g_mu, g_nu = _adam_all(
            state.g_params, grads, state.g_mu, state.g_nu, state.g_count + 1,
            self.opt.g_lr, self.opt.adam_b1, self.opt.adam_b2)
        m = {"g_adv_loss": adv.detach(), "g_aux_loss": aux.detach(),
             "g_aux_acc": 100.0 * _acc_vs_max(aux_o.detach(), y_onehot).mean()}
        return replace(state, g_params=g_params, g_mu=g_mu, g_nu=g_nu,
                       g_count=state.g_count + 1), m

    # ---------------- DCResNet (conv ghost) ----------------

    def row_weights(self, y: torch.Tensor) -> Optional[torch.Tensor]:
        """Per-row 1 / count of the row's class in the batch, for the ACGAN
        wasserstein aux loss (JAX steps.py _row_weights)."""
        if not (self.use_aux and self.aux_type == "wasserstein"):
            return None
        onehot = torch.nn.functional.one_hot(y.long(), self.n_classes).float()
        return 1.0 / torch.clamp(onehot @ onehot.sum(dim=0), min=1.0)

    def _penalty_grads(self, d_params: Params, pen_x, pen_y, fake, alphas):
        """(value, grads by name) of the gradient penalty on the public /
        mean-sample batch (JAX steps.py _penalty_grads)."""
        p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        with torch.enable_grad():
            def d_apply(xx, yy):
                return functional_call(self.D, p, (xx, yy))

            val = penalty_mod.calc_penalty(
                d_apply, self.penalty_types, pen_x, pen_y, fake, alphas,
                aux_penalty=self.aux_penalty, n_classes=self.n_classes)
            # The input gradient does not depend on the head biases: their
            # penalty gradient is zero.
            grads = torch.autograd.grad(val, [p[k] for k in self.d_leaves],
                                        allow_unused=True)
        return val.detach(), {k: torch.zeros_like(p[k]) if g is None else g
                              for k, g in zip(self.d_leaves, grads)}

    def fakes(self, g_params: Params, z, y):
        """Fresh fakes for a D step: a G forward without autograd."""
        with torch.no_grad():
            return functional_call(self.G, g_params, (z, y))

    def d_step_conv_ghost(self, state: TrainState, x, y, z,
                          noise: List[torch.Tensor], pen_x=None, pen_y=None,
                          alphas: Optional[List[torch.Tensor]] = None):
        """One gc D update of the DCResNet D (JAX _d_step_gc, conv-ghost
        branch): clipped real pass + per-leaf noise + clean fake pass
        [+ b * penalty grads], then /b and Adam. Returns (state, metrics)."""
        b = x.shape[0]
        fake = self.fakes(state.g_params, z, y)
        summed, stats, (r_out, r_aux) = conv_ghost.dcresnet_real_ghost(
            state.d_params, x, y, n_classes=self.n_classes, arch=self.arch,
            aux_type=self.aux_type, aux_scalar=self.aux_scalar,
            row_w=self.row_weights(y), max_norm=state.clipping,
            per_layer=self.per_layer, compute_dtype=self.compute_dtype)
        fake_grads, f_out = self._fake_sum_grads(state.d_params, fake, y)
        total = {k: (summed[k] + noise[i]) + fake_grads[k]
                 for i, k in enumerate(self.d_leaves)}
        pen_value = None
        if self.penalty_types:
            pen_value, pen_grads = self._penalty_grads(state.d_params, pen_x,
                                                       pen_y, fake, alphas)
            total = {k: t + pen_grads[k] * b for k, t in total.items()}
        grads = {k: t / b for k, t in total.items()}
        d_params, d_mu, d_nu = _adam_all(
            state.d_params, grads, state.d_mu, state.d_nu, state.d_count + 1,
            self.opt.d_lr, self.opt.adam_b1, self.opt.adam_b2)

        r_loss = losses.d_real_loss(self.family, r_out)
        f_loss = losses.d_fake_loss(self.family, f_out)
        m = {"d_adv_loss": r_loss + f_loss, "d_real_loss": r_loss,
             "d_fake_loss": f_loss,
             "d_real_acc": 100.0 * (r_out > 0).float().mean(),
             "d_fake_acc": 100.0 * (f_out < 0).float().mean(),
             "norm_mean": stats.norm_mean, "norm_std": stats.norm_std,
             "norm_max": stats.norm_max, "frac_clipped": stats.frac_clipped}
        if self.use_aux:
            m["d_real_aux_loss"] = losses.aux_loss(
                self.arch, self.aux_type, self.aux_scalar, r_aux, y, self.n_classes)
            m["d_real_aux_acc"] = 100.0 * (r_aux.argmax(dim=1) == y).float().mean()
        if pen_value is not None:
            m["penalty"] = pen_value
        return replace(state, d_params=d_params, d_mu=d_mu, d_nu=d_nu,
                       d_count=state.d_count + 1), m

    def g_step_dcresnet(self, state: TrainState, z, y):
        """G update against the current D: wgan adversarial loss + ACGAN aux
        loss (JAX _g_step); the GroupNorm+ReLU backward runs K5."""
        p = {k: v.detach().requires_grad_(True) for k, v in state.g_params.items()}
        with torch.enable_grad():
            img = functional_call(self.G, p, (z, y))
            out, aux_o = functional_call(self.D, state.d_params, (img, y))
            adv = losses.g_adv_loss(self.family, out)
            loss = adv
            if self.is_acgan:
                aux = losses.aux_loss(self.arch, self.aux_type, self.aux_scalar,
                                      aux_o, y, self.n_classes)
                loss = adv + aux
            grads = torch.autograd.grad(loss, [p[k] for k in self.g_leaves])
        g_params, g_mu, g_nu = _adam_all(
            state.g_params, dict(zip(self.g_leaves, grads)), state.g_mu,
            state.g_nu, state.g_count + 1, self.opt.g_lr, self.opt.adam_b1,
            self.opt.adam_b2)
        m = {"g_adv_loss": adv.detach()}
        if self.is_acgan:
            m["g_aux_loss"] = aux.detach()
            m["g_aux_acc"] = 100.0 * (aux_o.detach().argmax(dim=1) == y).float().mean()
        return replace(state, g_params=g_params, g_mu=g_mu, g_nu=g_nu,
                       g_count=state.g_count + 1), m
