"""Train-step math of the ported conditional ACGAN gc paths, in PyTorch.

The port's counterparts of the JAX package's training/steps.py pieces:

- ``d_step_gc``: the gc D step (JAX ``_d_step_gc``). With
  ``--grad_clip_split`` the private real pass is clipped per sample and the
  clean fake pass summed (``fake_sum``); the real pass takes, in this order
  of preference, ghost clipping for the vanilla D (ops/ghost.py), conv ghost
  clipping for the DCResNet D (ops/conv_ghost.py, K2/K3), the two-pass route
  (fp32 wgan models with flat clipping) or the materialized
  per-sample-gradient route (``ops/grads.clipped_grad_sum`` over
  ``real_ps_args``). Without the split, real and fake are clipped together
  over ``combined_ps_args``, always materialized. Then the WGAN-GP penalty
  on mean samples scaled by the batch size, the noise and Adam. Under
  ``--pallas true`` the materialized route's sum and noise are fused (K6,
  ops/pallas_clip.py).
- MNIST vanilla: ``d_step`` (the gc step above or the non-private D step) and
  ``g_step`` (``_g_step``); they are the plain version of K1
  (ops/pallas_epoch.py ``epoch_plain``).
- DCResNet: ``g_step_dcresnet``, the G step through the K4/K5 GroupNorm+ReLU
  layers.
- optax's Adam.

All randomness is an explicit input (z, labels, per-leaf DP noise or the
fused route's seeds and small-leaf normals, penalty interpolation weights,
mean-sample surrogates), so the same inputs give the same values in both
packages. Parameters are dicts of torch state-dict names;
per-leaf lists follow the JAX leaf order (``StepBuilder.d_leaves``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.func import functional_call

from csl_gan_tpu_torch.models import losses
from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.models.dcresnet import DCResNetDiscriminator, d_leaves
from csl_gan_tpu_torch.models.mnist import D_LEAVES, G_LEAVES, MNISTVanillaD
from csl_gan_tpu_torch.ops import conv_ghost, ghost
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.training import param_order
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
    # C of flat clipping, or the per-leaf thresholds in leaf order.
    clipping: Union[float, Tuple[float, ...]]


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
        self.grad_clip_split = bool(opt.grad_clip_split)
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
        self.use_pallas = bool(opt.pallas) and self.chunk is None
        self.use_ghost = (isinstance(D, MNISTVanillaD) and self.dp_mode == "gc"
                          and self.grad_clip_split and not self.use_bpc
                          and self.chunk is None)
        # DCResNet D: conv ghost clipping (ops/conv_ghost.py) for the private
        # real pass, bf16 compute under --bf16.
        dcresnet = isinstance(D, DCResNetDiscriminator)
        self.use_conv_ghost = (dcresnet and self.dp_mode == "gc"
                               and self.grad_clip_split
                               and bool(opt.conv_ghost) and not self.use_bpc
                               and self.chunk is None)
        self.compute_dtype = torch.bfloat16 if dcresnet and opt.bf16 else None
        # Conv models with flat clipping and conv ghost off: a norms-only pass
        # plus one weighted backward. bf16 is excluded: the weighted backward
        # would round the summed gradient to bf16, breaking the clip bound at
        # the sum's magnitude, while the one-pass route sums fp32 per-sample
        # gradients in fp32 (the JAX package's steps.py:181-189).
        self.use_two_pass = (not self.use_ghost and not self.use_conv_ghost
                             and self.family == "wgan" and self.dp_mode == "gc"
                             and not self.per_layer and self.chunk is None
                             and not self.use_bpc and self.compute_dtype is None)
        # The gc D step materializes per-sample gradients when real and fake
        # are clipped together or no cheaper route serves the real pass; under
        # --pallas its weighted sum and noise are fused (K6). In the JAX
        # package the fused route runs only on its accelerator; here it runs
        # wherever the step does, on K6 for CUDA tensors and on K6's plain
        # version for CPU tensors.
        self.materialized = self.dp_mode == "gc" and (
            not self.grad_clip_split
            or not (self.use_ghost or self.use_conv_ghost or self.use_two_pass))
        self.fused_route = self.use_pallas and self.materialized
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
        clipping = float(self.opt.clipping_param or 1.0)
        if self.per_layer:
            clipping = tuple(self._per_layer_clipping())
        return TrainState(d, g, zeros(d), zeros(d), zeros(g), zeros(g), 0, 0, clipping)

    def _per_layer_clipping(self) -> List[float]:
        """The torch-order ``-cpl`` vector in leaf order (the JAX package's
        ``_per_layer_vector``): ones without a vector; a dataset default is
        rebuilt by leaf role (param_order.default_clipping_per_layer); a
        user's vector of the wrong length is a config error."""
        vec = self.opt.clipping_param_per_layer
        n = len(self.d_leaves)
        if vec is None:
            return [1.0] * n
        if not self.opt.cpl_user_set:
            return param_order.default_clipping_per_layer(self.d_leaves)
        torch_names = list(self.D.state_dict())
        if len(vec) != n:
            raise ValueError(
                f"--clipping_param_per_layer (-cpl) has {len(vec)} entries but the "
                f"discriminator has {n} parameters; expected one entry per "
                f"parameter in torch order: [{', '.join(torch_names)}]")
        return param_order.from_torch_order(vec, self.d_leaves, torch_names)

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
        """One D update of the vanilla model: the gc step (``d_step_gc``) or,
        without DP, plain summed grads; then /bs and Adam. Returns
        (state, metrics)."""
        if use_dp:
            return self.d_step_gc(state, x, y, z, noise=noise)
        b = x.shape[0]
        fake = self.fakes(state.g_params, z, y)
        summed, r_out, r_aux = self._real_sum_grads(state.d_params, x, y)
        fake_grads, f_out = self._fake_sum_grads(state.d_params, fake, y)
        grads = {k: (summed[k] + fake_grads[k]) / b for k in self.d_leaves}
        return (self._apply_d(state, grads),
                self._d_metrics(r_out, r_aux, f_out, y, y_onehot))

    def _apply_d(self, state: TrainState, grads: Params) -> TrainState:
        d_params, d_mu, d_nu = _adam_all(
            state.d_params, grads, state.d_mu, state.d_nu, state.d_count + 1,
            self.opt.d_lr, self.opt.adam_b1, self.opt.adam_b2)
        return replace(state, d_params=d_params, d_mu=d_mu, d_nu=d_nu,
                       d_count=state.d_count + 1)

    def _d_metrics(self, r_out, r_aux, f_out, y, y_onehot, stats=None, pen_value=None):
        r_loss = losses.d_real_loss(self.family, r_out)
        f_loss = losses.d_fake_loss(self.family, f_out)
        m = {"d_adv_loss": r_loss + f_loss, "d_real_loss": r_loss,
             "d_fake_loss": f_loss,
             "d_real_acc": 100.0 * (r_out > 0).to(torch.float32).mean(),
             "d_fake_acc": 100.0 * (f_out < 0).to(torch.float32).mean()}
        if self.use_aux:
            m["d_real_aux_loss"] = losses.aux_loss(
                self.arch, self.aux_type, self.aux_scalar, r_aux, y, self.n_classes)
            m["d_real_aux_acc"] = 100.0 * _acc_vs_max(r_aux, y_onehot).mean()
        if stats is not None:
            m.update(norm_mean=stats.norm_mean, norm_std=stats.norm_std,
                     norm_max=stats.norm_max, frac_clipped=stats.frac_clipped)
        if pen_value is not None:
            m["penalty"] = pen_value
        return m

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

    # ---------------- penalty and fakes ----------------

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

    # ---------------- the gc D step ----------------

    def _d_apply(self, d_params: Params, x, y, aux: bool = True):
        return functional_call(self.D, d_params, (x, y), {"aux": aux})

    def _aux_single(self, aux_row, yi, wi):
        """Aux loss of ONE sample (aux_row: [n_classes]), the per-sample form
        of models/losses.aux_loss (JAX steps.py ``_aux_single``); ``wi`` is the
        sample's 1 / count of its class in the batch."""
        if not self.use_aux or aux_row is None:
            return 0.0
        onehot = one_hot(yi, self.n_classes)
        if self.aux_type == "cross_entropy":
            return -self.aux_scalar * torch.sum(onehot * torch.log_softmax(aux_row, dim=-1))
        sign = onehot * -2.0 + 1.0
        return self.aux_scalar * torch.sum(sign * torch.sigmoid(aux_row)) * wi

    def real_ps_args(self, x, y, row_w):
        """(loss_fn, batch args) of the per-sample REAL pass (JAX steps.py
        ``_real_ps_args``, without the per-sample penalty):
        loss_fn(d_params, x_i, y_i, w_i) is the real loss of one sample."""
        w = row_w if row_w is not None else torch.ones(x.shape[0], device=x.device)

        def f(d_params, xi, yi, wi):
            out, aux_o = self._d_apply(d_params, xi[None], yi[None])
            loss = losses.d_real_loss(self.family, out, "none")[0]
            return loss + self._aux_single(None if aux_o is None else aux_o[0], yi, wi)

        return f, (x, y, w)

    def combined_ps_args(self, x, y, fake, row_w):
        """(loss_fn, batch args) for real + fake clipped together
        (--grad_clip_split false; JAX steps.py ``_combined_ps_args``)."""
        w = row_w if row_w is not None else torch.ones(x.shape[0], device=x.device)

        def f(d_params, xi, yi, fi, wi):
            r_out, r_aux = self._d_apply(d_params, xi[None], yi[None])
            f_out, f_aux = self._d_apply(d_params, fi[None], yi[None], aux=self.d_fake_aux)
            loss = losses.d_real_loss(self.family, r_out, "none")[0] \
                + losses.d_fake_loss(self.family, f_out, "none")[0]
            loss = loss + self._aux_single(None if r_aux is None else r_aux[0], yi, wi)
            if self.d_fake_aux:
                loss = loss + self._aux_single(None if f_aux is None else f_aux[0], yi, wi)
            return loss

        return f, (x, y, fake, w)

    def d_step_gc(self, state: TrainState, x, y, z,
                  noise: Optional[List[torch.Tensor]] = None,
                  fused: Optional[gops.FusedNoise] = None,
                  pen_x=None, pen_y=None,
                  alphas: Optional[List[torch.Tensor]] = None):
        """One gc D update (JAX ``_d_step_gc``): the clipped private pass by
        the route the config selects (see the module docstring), the clean
        fake pass [+ b * penalty grads], the DP noise, then /b and Adam.

        The noise is either ``noise``, per-leaf draws in leaf order that are
        added to the sum, or, on the fused route (``self.fused_route``),
        ``fused``: per-leaf seeds for K6 and normals for the small leaves.
        Returns (state, metrics)."""
        if (fused is None) == (noise is None) or (fused is not None) != self.fused_route:
            raise ValueError("d_step_gc takes per-leaf noise, or fused noise exactly "
                             "on the fused route (--pallas true, materialized)")
        b = x.shape[0]
        d_params, clipping = state.d_params, state.clipping
        fake = self.fakes(state.g_params, z, y)
        row_w = self.row_weights(y)
        ghost_outs = None
        if self.grad_clip_split:
            # Private real pass: per-sample clip; clean fake pass: summed grads.
            if self.use_ghost:
                summed, stats, ghost_outs = ghost.vanilla_real_ghost(
                    d_params, x, one_hot(y, self.n_classes), y if self.use_aux else None,
                    self.aux_scalar, clipping, self.per_layer)
            elif self.use_conv_ghost:
                summed, stats, ghost_outs = conv_ghost.dcresnet_real_ghost(
                    d_params, x, y, n_classes=self.n_classes, arch=self.arch,
                    aux_type=self.aux_type, aux_scalar=self.aux_scalar, row_w=row_w,
                    max_norm=clipping, per_layer=self.per_layer,
                    compute_dtype=self.compute_dtype)
            elif self.use_two_pass:
                f, args = self.real_ps_args(x, y, row_w)
                summed, stats = gops.two_pass_clipped_grad_sum(
                    f, d_params, *args, max_norm=clipping, per_layer=False)
            else:
                f, args = self.real_ps_args(x, y, row_w)
                summed, stats = gops.clipped_grad_sum(
                    f, d_params, *args, max_norm=clipping, per_layer=self.per_layer,
                    chunk=self.chunk, fused_noise=fused)
            fake_grads, f_out = self._fake_sum_grads(d_params, fake, y)
        else:
            f, args = self.combined_ps_args(x, y, fake, row_w)
            summed, stats = gops.clipped_grad_sum(
                f, d_params, *args, max_norm=clipping, per_layer=self.per_layer,
                chunk=self.chunk, fused_noise=fused)
            fake_grads = None
            with torch.no_grad():
                f_out = self._d_apply(d_params, fake, y, aux=False)[0]
        if noise is not None:
            summed = {k: summed[k] + noise[i] for i, k in enumerate(self.d_leaves)}
        total = summed if fake_grads is None else \
            {k: summed[k] + fake_grads[k] for k in self.d_leaves}
        pen_value = None
        if self.penalty_types:
            pen_value, pen_grads = self._penalty_grads(d_params, pen_x, pen_y, fake, alphas)
            total = {k: t + pen_grads[k] * b for k, t in total.items()}
        grads = {k: t / b for k, t in total.items()}

        if ghost_outs is not None:
            r_out, r_aux = ghost_outs
        else:
            with torch.no_grad():
                r_out, r_aux = self._d_apply(d_params, x, y)
        metrics = self._d_metrics(r_out, r_aux, f_out, y, one_hot(y, self.n_classes),
                                  stats, pen_value)
        return self._apply_d(state, grads), metrics

    def d_step_conv_ghost(self, state: TrainState, x, y, z,
                          noise: List[torch.Tensor], pen_x=None, pen_y=None,
                          alphas: Optional[List[torch.Tensor]] = None):
        """``d_step_gc`` with per-leaf noise, by its earlier name."""
        return self.d_step_gc(state, x, y, z, noise=noise, pen_x=pen_x, pen_y=pen_y,
                              alphas=alphas)

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
