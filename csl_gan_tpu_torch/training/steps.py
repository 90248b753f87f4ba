"""Train-step math of the port, in PyTorch: unconditional runs and the
CGAN, ACGAN and WCGAN conditional variants.

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
  on mean samples or public rows scaled by the batch size, the noise and
  Adam. Under ``--pallas true`` the materialized route's sum and noise are
  fused (K6, ops/pallas_clip.py). Under ``-gcm adaptive`` / ``adaptive-pl``
  each step first takes its thresholds from the per-sample norms of a
  public or mean-sample batch (``adaptive_clipping``) and keeps them, a
  device tensor, in the state. Under ``--poisson`` the batch is a [cap]
  buffer with a validity mask (``poisson_draw``): masked rows have zero
  cotangents on the ghost routes and a zero-weighted loss on the others
  (``ops/grads.mask_loss``), and the step divides by the expected batch.
  Under ``-pupd false`` each sample's penalty (WGAN-GP or DRAGAN, on its
  real row and fake) is a term of its clipped loss, which takes the
  materialized route. Under ``--backprop_clip`` the vanilla D clips its
  activations and cotangents in every clipped pass (``_d_apply(...,
  bpc=True)``).
- ``d_step_is``: the immediate-sensitivity D step (JAX ``_d_step_is``): the
  full-batch gradient g of the D loss, the sensitivity as the norm of the
  input gradient of ||g|| (flat), of ||(||g_l|| / v_l)_l|| (``-issm
  constant-pl`` / ``moving-avg-pl``, v the state's ``scaling_vec``) or of
  each ||g_l|| (``-ispp true``, one batched backward), by second-order
  autograd; noise with the
  per-leaf stds sigma * sens [* v_l] as a device tensor; Adam; under
  moving-avg-pl, v <- beta v + (1 - beta) ||noised g_l||.
- ``d_step_tmsv``: trimmed mean / sign vote over the materialized per-sample
  gradients of real + fake (JAX ``_d_step_tmsv``; ops/tmsv.py).
- ``d_step_plain``: the non-private full-batch D step with the WGAN-GP
  penalty (JAX ``_d_step_plain``), the DCResNet's.
- ``d_core``: the D step by ``dp_mode``, as JAX ``_d_core`` dispatches.
- MNIST vanilla: ``d_step`` (the gc step above or the non-private D step) and
  ``g_step`` (``_g_step``); they are the plain version of K1
  (ops/pallas_epoch.py ``epoch_plain``).
- DCResNet: ``g_step_dcresnet``, the G step through the K4/K5 GroupNorm+ReLU
  layers.
- optax's Adam, and ``reset_optimizers`` (fresh Adam states after a
  warmup).

All randomness is an explicit input (z, labels, per-leaf DP noise or the
fused route's seeds and small-leaf normals, the penalties' draws: WGAN-GP's
interpolation weights, DRAGAN's U(0, 1) noise; mean-sample surrogates, the
Poisson inclusion), so the same inputs give the same values in both
packages. As in the JAX package, the D and G see labels only when the run
is conditional (labels are None otherwise, ``_d_apply``); the ACGAN aux
loss is the only one that is not zero (``_aux_batch``, ``_aux_single``),
and the G step adds it for ACGAN alone. Parameters are dicts of torch
state-dict names; per-leaf lists follow the JAX leaf order
(``StepBuilder.d_leaves``).

Under a data axis (``mesh``, a ``parallel.MeshContext`` with more than one
rank) every step takes the global batch's inputs, the same on every rank,
and keeps this rank's rows (``_rows``): D and G run on them, so K2-K6 and
K4/K5 see B / N rows. A quantity that the JAX step takes over the batch
becomes a sum over local rows, all-reduced: the clipped sums, the fake-pass
and penalty gradients, the votes (one flat all-reduce a step,
``_reduce``). D's per-row outputs are gathered (``_gather_out``, whose
backward is the slice of this rank's rows), so every loss, metric and clip
statistic is the single-device function of the whole batch, on every rank,
and its gradient through the local rows is this rank's share. The
division stays by the global batch. Only rank 0 adds the gc noise before
the reduction (on the fused route the other ranks pass K6 a zero std), so
it enters once. The is step's gradient is reduced with an identity
backward (``sum_replicated``) before its sensitivity; tm gathers the
per-sample gradients for its sort. Under ``--fsdp`` the state holds shards:
``d_core`` / ``g_core`` gather the params whole for the step, Adam updates
each rank's shard (``_adam_all``), and the moments stay shards. With one
rank every collective is the identity and the arithmetic is unchanged.

Under a model axis (``--tp``; ``mesh.tp`` > 1) the rows are those of the
rank's data index and the reductions run over its data group. The state
holds each rank's slice of the output channels of every leaf that
``mesh.leaf_layout`` shards (``d_sharded``; Adam's moments follow), G and D
run column-parallel on them (models/*.py take the forwards' ``mesh``), and
the gc routes clip on the slices: each slice's per-sample squared norms are
summed over the model group (``_sq_reduce``, the ghost routes' own sums),
the sums are the rank's slices, and the ranks of data index 0 add each
slice's part of the one-device noise draw (``_model_cut``; on the fused
route K6 at the slice's counter base, ``_local_fused``). The other engines
run on the slices too: the is step's norms of g, differentiated, and its
moving-avg-pl norms sum the slices' squares over the model group
(``_sq_reduce``), as adaptive clipping's per-sample norms do; tm sorts and
sv votes on each coordinate of the rank's slices; every engine's noise is
the slices' part of the one-device draw. Poisson's mask, DRAGAN's batch
std and the per-sample penalty's rows are the data axis's, the same on
every model rank; backprop clipping clips the whole input and the gathered
output's cotangent of each layer (models/mnist.py). A step gathers --fsdp's
data shards to the rank's slices (``step_params``); a save or a grid
gathers whole leaves (``full_state`` / ``full_params``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import functional_call

from csl_gan_tpu_torch.models import losses
from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.models.dcresnet import BatchNormRelu, DCResNetDiscriminator, d_leaves
from csl_gan_tpu_torch.models.mnist import G_LEAVES, MNISTVanillaD
from csl_gan_tpu_torch.models.mnist import d_leaves as mnist_d_leaves
from csl_gan_tpu_torch.ops import conv_ghost, ghost, tmsv
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.parallel.mesh import MeshContext
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
    # C of flat clipping, or the per-leaf thresholds in leaf order: host
    # floats, or under adaptive clipping an fp32 tensor (0-d, or
    # [n_leaves]) on the params' device that each gc D step replaces.
    clipping: Union[float, Tuple[float, ...], torch.Tensor]
    # The IS scaling v: an fp32 [n_leaves] tensor in leaf order on the
    # params' device (-issm constant-pl / moving-avg-pl), else the 0.0
    # placeholder of the JAX TrainState.
    scaling_vec: Union[float, torch.Tensor] = 0.0
    # The running averages of a BatchNorm G (-dpm is and non-private
    # DCResNet runs) by buffer name, else empty.
    g_batch_stats: Params = field(default_factory=dict)


def adam_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, t: int, lr: float, b1: float, b2: float,
                eps: float = 1e-8, wd: float = 0.0):
    """optax scale_by_adam (eps_root=0) + scale(-lr) + apply_updates, with the
    bias correction 1 - exp(t * ln b) in fp32 as K1 computes it
    (JAX ops/pallas_epoch.py:172-182). With ``wd`` the L2 decay wd * p is
    added to the gradient before the moments (optax add_decayed_weights
    first in the chain, JAX training/steps.py:73-86). Returns (p, m, v)."""
    if wd:
        g = g + wd * p
    m = b1 * m + (1.0 - b1) * g
    v = b2 * v + (1.0 - b2) * (g * g)
    tt = torch.tensor(float(t), dtype=torch.float32, device=p.device)

    def bias_correction(b):       # 1 - b**t; 0**t = 0 for t >= 1 (b1 = 0)
        return 1.0 if b == 0.0 else 1.0 - torch.exp(tt * math.log(b))

    u = (m / bias_correction(b1)) / (torch.sqrt(v / bias_correction(b2)) + eps)
    return p - lr * u, m, v


def _adam_all(params: Params, grads: Params, mu: Params, nu: Params, t: int,
              lr: float, b1: float, b2: float, wd: float = 0.0, shard=None):
    """Adam over every leaf. Under ``--fsdp`` a leaf whose moments are a
    shard updates this rank's shard (``shard(name, t)``) of its params and
    reduced gradient (Adam is elementwise), so the new params are shards
    too."""
    new_p, new_m, new_v = {}, {}, {}
    for k in params:
        p, g = params[k], grads[k]
        if shard is not None and mu[k].shape != p.shape:
            p, g = shard(k, p), shard(k, g)
        new_p[k], new_m[k], new_v[k] = adam_update(p, g, mu[k], nu[k], t, lr, b1, b2, wd=wd)
    return new_p, new_m, new_v


def _acc_vs_max(logits: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """argmax(logits) == label, computed as "the true label's logit attains
    the row max" (K1's form; identical off exact ties)."""
    true_logit = torch.sum(onehot * logits, dim=1)
    return (true_logit >= logits.amax(dim=1)).to(torch.float32)


class StepBuilder:
    """Config of the ported step functions (the JAX TrainStepBuilder's
    fields that the epoch kernel's gate reads) plus the step math."""

    def __init__(self, opt, G, D, label1_prob: float = 0.5,
                 mesh: Optional[MeshContext] = None):
        self.opt = opt
        self.G, self.D = G, D
        # The data and model axes (parallel/mesh.py); one device without a
        # group. The forwards take the mesh only under a tensor axis.
        self.mesh = mesh if mesh is not None else MeshContext()
        self._tp = self.mesh if self.mesh.tp > 1 else None
        for m in G.modules():
            if isinstance(m, BatchNormRelu):
                m.mesh = self.mesh if self.mesh.grouped else None
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
        self.adaptive_stat = opt.adaptive_stat
        self.adaptive_scalar = float(opt.adaptive_scalar)
        # Device copies of constant clipping thresholds, for the per-step
        # "clipping" metric: (value, device) -> fp32 tensor.
        self._clip_consts: Dict[tuple, torch.Tensor] = {}
        # Exact Poisson subsampling (--poisson, gc): each DP step includes
        # every row with probability q = B / N, packed into a [cap] buffer
        # with a validity mask; cap = B + ceil(8 sqrt(B)) (overflow ~1e-15),
        # never more than the dataset (JAX steps.py:122-136).
        self.poisson = bool(opt.poisson)
        if self.poisson:
            self.poisson_q = opt.batch_size / opt.train_set_size
            self.poisson_cap = min(opt.batch_size + math.ceil(8.0 * math.sqrt(opt.batch_size)),
                                   opt.train_set_size)
        self.penalty_types = list(opt.penalty or [])
        # -pupd false under gc: each sample's penalty on its own real row
        # (and fake) is folded into its clipped loss (JAX steps.py:746).
        self.ps_pen = (self.dp_mode == "gc" and bool(self.penalty_types)
                       and not opt.penalty_use_public_data)
        self.use_bpc = bool(opt.backprop_clip)
        self.bpc_g = bool(opt.bpc_during_g_train)
        self.chunk = opt.per_sample_chunk
        self.is_acgan = bool(opt.is_acgan)
        self.aux_penalty = bool(opt.aux_penalty)
        # Bernoulli(label1_prob) labels for two classes (the CelebA label
        # frequency; the JAX package's gen_y).
        self.label1_prob = label1_prob
        self.is_per_param = bool(opt.imm_sens_per_param)
        self.is_scaling_mode = opt.imm_sens_scaling_mode or "standard"
        self.moving_avg_beta = float(opt.moving_avg_beta)
        # tm/sv knobs (reference train.py:118-133, its min/max swap undone).
        steps_per_epoch = max(1, opt.train_set_size // opt.batch_size)
        self.tm_m = int(opt.tm_m)
        lo, hi = opt.tm_min_val, opt.tm_max_val
        self.tm_min_val, self.tm_max_val = min(lo, hi), max(lo, hi)
        self.smooth_sens_t = float(opt.smooth_sens_t)
        self.rho_per_step = opt.tm_rho_per_epoch / steps_per_epoch
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
        # --bf16: the DCResNet pair computes in bf16; the vanilla MLP in fp32
        # whatever the flag (JAX models/mnist.py:24), so there the flag only
        # takes the run off K1 (its gate reads compute_dtype).
        self.compute_dtype = torch.bfloat16 if opt.bf16 else None
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
        # are clipped together, the per-sample penalty is on (it turns the
        # ghost, conv-ghost and two-pass routes off, as the JAX step does per
        # call) or no cheaper route serves the real pass; under
        # --pallas its weighted sum and noise are fused (K6). In the JAX
        # package the fused route runs only on its accelerator; here it runs
        # wherever the step does, on K6 for CUDA tensors and on K6's plain
        # version for CPU tensors.
        self.materialized = self.dp_mode == "gc" and (
            not self.grad_clip_split or self.ps_pen
            or not (self.use_ghost or self.use_conv_ghost or self.use_two_pass))
        self.fused_route = self.use_pallas and self.materialized
        self.d_leaves = tuple(d_leaves(D) if dcresnet else mnist_d_leaves(D))
        # A CGAN or WCGAN DCResNet D sees the label as one-hot input planes.
        self.concat_planes = dcresnet and D.planes
        self.g_leaves = tuple(n for n, _ in G.named_parameters()) if dcresnet else G_LEAVES
        self.g_stat_names = tuple(n for n, _ in G.named_buffers())
        self.g_has_bn = bool(self.g_stat_names)
        self.img_shape = (28, 28, 1)
        # Set by the Trainer when the device table is [x | one-hot | label]
        # (or, under --u8_table, the uint8 [x * 255 | label]).
        self.labels_in_table = False
        self.onehot_in_table = False
        # -wd: L2 decay of D's parameters, folded into D's gradient before
        # Adam on every D-step engine (JAX make_optimizers).
        self.weight_decay = float(opt.weight_decay or 0)
        # The whole shapes of the leaves (--fsdp's state holds shards), and
        # shape-only stand-ins of D's, from which a step's noise is drawn.
        self.d_shapes = {k: tuple(v.shape) for k, v in D.state_dict().items()
                         if k in self.d_leaves}
        self.g_shapes = {k: tuple(v.shape) for k, v in G.state_dict().items()
                         if k in self.g_leaves}
        self.d_templates = tuple(torch.empty(self.d_shapes[k], device="meta")
                                 for k in self.d_leaves)
        # D's leaves that the tensor axis cuts (their torch dim 0).
        self.d_sharded = tuple(k for k in self.d_leaves
                               if self.mesh.model_dim(k, self.d_shapes[k]) is not None)
        # The map of [n_leaves, rows] squared norms that makes each sharded
        # leaf's the whole leaf's; None without a sharded leaf.
        self.sq_reduce = self._sq_reduce if self.d_sharded else None

    # ---------------- state and randomness ----------------

    def init_state(self) -> TrainState:
        d = {k: v.detach().clone() for k, v in self.D.state_dict().items()}
        g = {k: v.detach().clone() for k, v in self.G.state_dict().items()}
        d = {k: d[k] for k in self.d_leaves}
        stats = {k: g[k] for k in self.g_stat_names}
        g = {k: g[k] for k in self.g_leaves}
        zeros = lambda t: {k: torch.zeros_like(v) for k, v in t.items()}  # noqa: E731
        # fp32 values, as the JAX TrainState holds them: a checkpoint then
        # carries the clipping exactly.
        clipping = float(np.float32(self.opt.clipping_param or 1.0))
        if self.per_layer:
            clipping = tuple(float(np.float32(c)) for c in self._per_layer_vector(
                "clipping_param_per_layer", "-cpl", "cpl_user_set",
                param_order.default_clipping_per_layer))
        if self.adaptive and self.dp_mode == "gc":
            clipping = torch.tensor(clipping, dtype=torch.float32,
                                    device=d[self.d_leaves[0]].device)
        scaling_vec = 0.0
        if self.is_scaling_mode != "standard":
            scaling_vec = torch.tensor(
                self._per_layer_vector("imm_sens_scaling_vec", "-issv", "issv_user_set",
                                       param_order.default_is_scaling_per_layer),
                dtype=torch.float32, device=d[self.d_leaves[0]].device)
        return TrainState(d, g, zeros(d), zeros(d), zeros(g), zeros(g), 0, 0, clipping,
                          scaling_vec, stats)

    def reset_optimizers(self, state: TrainState) -> TrainState:
        """Fresh Adam moments and counts for G and D, as after a warmup (JAX
        steps.py:320-324; reference train.py:572)."""
        zeros = lambda t: {k: torch.zeros_like(v) for k, v in t.items()}  # noqa: E731
        return replace(state, d_mu=zeros(state.d_mu), d_nu=zeros(state.d_nu),
                       g_mu=zeros(state.g_mu), g_nu=zeros(state.g_nu), d_count=0,
                       g_count=0)

    # ---------------- the data axis and --fsdp ----------------

    _TREES = (("d_params", "d"), ("g_params", "g"), ("d_mu", "d"), ("d_nu", "d"),
              ("g_mu", "g"), ("g_nu", "g"))

    def _rows(self, *ts):
        """This rank's rows of each global batch tensor (a list element by
        element; None stays None); the tensors themselves on one device."""
        m = self.mesh
        return tuple([m.shard_rows(e) for e in t] if isinstance(t, (list, tuple))
                     else m.shard_rows(t) for t in ts)

    def _gather_out(self, n: int, *ts):
        """The whole batch's rows of per-row tensors (None stays None), every
        rank's rows in one collective; differentiable, the gradient of this
        rank's tensors being their rows of the incoming one. The tensors
        themselves without a process group."""
        if not self.mesh.grouped:
            return ts
        present = [t for t in ts if t is not None]
        widths = [math.prod(t.shape[1:]) for t in present]
        whole = self.mesh.gather_rows(
            torch.cat([t.reshape(t.shape[0], w).float() for t, w in zip(present, widths)],
                      dim=1), n)
        parts = iter(torch.split(whole, widths, dim=1))
        return tuple(None if t is None else
                     next(parts).reshape((n,) + tuple(t.shape[1:])).to(t.dtype) for t in ts)

    def _reduce(self, grads: Params) -> Params:
        """Per-rank sums of gradients, summed over the data group in one
        all-reduce (a model rank's slices are its own)."""
        return self.mesh.all_sum_dict(grads)

    def _sq_reduce(self, sq: torch.Tensor) -> torch.Tensor:
        """[n_leaves, rows] per-sample squared norms in leaf order with the
        sharded leaves' rows summed over the model group (one all-reduce);
        the replicated leaves' rows, each one full computation, as they
        are."""
        mask = torch.tensor([k in self.d_sharded for k in self.d_leaves], device=sq.device)
        return torch.where(mask[:, None], self.mesh.reduce_model(sq), sq)

    def _model_cut(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's model slice of a whole D-leaf-shaped tensor (a noise
        draw); the tensor itself where the leaf is replicated."""
        if self._tp is None:
            return t
        return self.mesh.cut(name, self.d_shapes[name], t, data=False)

    def _local_fused(self, fused: Optional[gops.FusedNoise]) -> Optional[gops.FusedNoise]:
        """The fused route's draws for this rank's slices: the small leaves'
        normals cut, and per leaf the counter base of the slice's first
        element in the whole leaf (the tensor axis cuts a D leaf's dim 0, a
        contiguous range of it)."""
        if fused is None or self._tp is None:
            return fused
        eps, bases = [], []
        for i, k in enumerate(self.d_leaves):
            shape = self.d_shapes[k]
            if self.mesh.model_dim(k, shape) is None:
                eps.append(fused.eps[i])
                bases.append(0)
                continue
            eps.append(None if fused.eps[i] is None else self._model_cut(k, fused.eps[i]))
            bases.append(self.mesh.model_index * (math.prod(shape) // self.mesh.tp))
        return fused._replace(eps=eps, bases=bases)

    def _g_apply(self, params: Params, z, y, **kw):
        """The G forward on ``params`` (column-parallel under a tensor axis)."""
        if self._tp is not None:
            kw["mesh"] = self._tp
        return functional_call(self.G, params, (z, y), kw)

    def _stats_gather(self, n: int):
        """``stats_from_norms``'s gather of [n_leaves, rows] columns."""
        return (lambda t: self.mesh.gather_cols(t, n)) if self.mesh.grouped else None

    def _pen_kw(self, pen_x) -> dict:
        """``calc_penalty``'s data-axis arguments for a penalty batch of
        which this rank has its rows: the mean over the whole batch's rows
        and, for DRAGAN, the whole real batch's std."""
        if not self.mesh.grouped or pen_x is None or not self.penalty_types:
            return {}
        n = pen_x.shape[0]
        kw = {"batch_mean": lambda gp: self.mesh.gather_rows(gp, n).mean()}
        if any(t.startswith("DRAGAN") for t in self.penalty_types):
            kw["real_std"] = torch.std(pen_x, correction=0)
        return kw

    def _whole(self, state: TrainState, fields, data_only: bool = False) -> TrainState:
        """``state`` with the trees ``fields`` whole (one all-reduce), or
        with ``data_only`` gathered over the data axis to the rank's model
        slices; the state itself unless --fsdp or --tp cuts it."""
        if not self.mesh.shards_state or (data_only and not self.mesh.fsdp):
            return state
        shapes = {"d": self.d_shapes, "g": self.g_shapes}
        tree, shp, names = {}, {}, {}
        for f, side in fields:
            for k, v in getattr(state, f).items():
                tree[(f, k)], shp[(f, k)], names[(f, k)] = v, shapes[side][k], k
        whole = self.mesh.unshard(tree, shp, names, data_only=data_only)
        return replace(state, **{f: {k: whole[(f, k)] for k in getattr(state, f)}
                                 for f, _ in fields})

    def full_params(self, state: TrainState) -> TrainState:
        """``state`` with D's and G's params whole (--fsdp, --tp): a grid's
        or a tool's single-device G."""
        return self._whole(state, self._TREES[:2])

    def step_params(self, state: TrainState) -> TrainState:
        """``state`` with D's and G's params as a step takes them: --fsdp's
        shards gathered, each leaf whole or (--tp) this rank's slice."""
        return self._whole(state, self._TREES[:2], data_only=True)

    def full_state(self, state: TrainState) -> TrainState:
        """``state`` with params and Adam moments whole (--fsdp, --tp): what
        a save writes, the single-device state."""
        return self._whole(state, self._TREES)

    def shard_state(self, state: TrainState) -> TrainState:
        """``state`` with every whole leaf that --fsdp or --tp cuts reduced
        to this rank's block (params and moments); the state itself
        otherwise."""
        if not self.mesh.shards_state:
            return state
        shapes = {"d": self.d_shapes, "g": self.g_shapes}
        return replace(state, **{f: self.mesh.shard_tree(getattr(state, f), shapes[side])
                                 for f, side in self._TREES})

    def _adam_shard(self, side: str):
        """Under --fsdp, the cut of a D (``side`` "d") or G leaf's step value
        (whole, or its model slice) to this rank's data shard."""
        if not self.mesh.fsdp:
            return None
        shapes = self.d_shapes if side == "d" else self.g_shapes
        return lambda k, t: self.mesh.cut(k, shapes[k], t, model=False)

    def _per_layer_vector(self, flag: str, cli: str, user_set: str,
                          default_builder) -> List[float]:
        """A torch-order per-layer CLI vector (``-cpl``, ``-issv``) in leaf
        order (the JAX package's ``_per_layer_vector``): ones without a
        vector; a dataset default is rebuilt by leaf role
        (``default_builder``); a user's vector of the wrong length is a
        config error."""
        vec = getattr(self.opt, flag)
        n = len(self.d_leaves)
        if vec is None:
            return [1.0] * n
        if not getattr(self.opt, user_set):
            return default_builder(self.d_leaves)
        torch_names = list(self.D.state_dict())
        if len(vec) != n:
            raise ValueError(
                f"--{flag} ({cli}) has {len(vec)} entries but the "
                f"discriminator has {n} parameters; expected one entry per "
                f"parameter in torch order: [{', '.join(torch_names)}]")
        return param_order.from_torch_order(vec, self.d_leaves, torch_names)

    def gen_z(self, gen: torch.Generator, size: int, lead: tuple = ()):
        return torch.randn(lead + (size, self.latent), generator=gen,
                           device=gen.device, dtype=torch.float32)

    def gen_y(self, gen: torch.Generator, size: int, lead: tuple = ()):
        """Class labels (reference train.py:153-161): Bernoulli(label1_prob)
        for fewer than three classes, uniform otherwise, None when unconditional (the JAX
        package's gen_y)."""
        if not self.conditional:
            return None
        if self.n_classes < 3:
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
        """(x, y, one-hot) of gathered table rows; uint8 rows (``--u8_table``)
        dequantize their pixels as u8 / 255 in fp32 (the loader's own math,
        JAX training/loop.py:312-333)."""
        u8 = rows.dtype == torch.uint8
        rows = rows.to(torch.float32)
        f = 1
        for d in self.img_shape:
            f *= d
        pix = rows[:, :f] / 255.0 if u8 else rows[:, :f]
        x = pix.reshape((rows.shape[0],) + tuple(self.img_shape))
        onehot = rows[:, f:f + self.n_classes] if self.onehot_in_table else None
        return x, rows[:, -1].to(torch.int64), onehot

    # ---------------- D steps ----------------

    def _aux_batch(self, aux_out, y, fake: bool, reduction: str = "mean"):
        """The aux loss of a batch (JAX steps.py ``_aux_batch``): zero
        without an aux loss or head, and on a WCGAN's fakes."""
        if not self.use_aux or aux_out is None or (fake and self.arch == "WCGAN"):
            return 0.0
        return losses.aux_loss(self.arch, self.aux_type, self.aux_scalar, aux_out, y,
                               self.n_classes, reduction=reduction)

    def _fake_sum_grads(self, d_params: Params, fake: torch.Tensor, y, valid=None,
                        bpc: bool = False, n: Optional[int] = None, yg=None):
        """Summed grads of the clean fake pass (JAX steps.py fake_sum):
        sum_i valid_i loss(out_i, fake) [+ the aux terms when d_fake_aux];
        through the backprop-clipped D with ``bpc``. Under a data axis
        ``fake`` and ``y`` are this rank's rows, ``n``, ``yg`` and ``valid``
        the whole batch's count, labels and mask: the grads are this rank's
        share, which the caller reduces. Returns (grads, the whole batch's
        outputs)."""
        n = fake.shape[0] if n is None else n
        yg = y if yg is None else yg
        p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        with torch.enable_grad():
            out, aux_o = self._d_apply(p, fake, y, aux=self.d_fake_aux, bpc=bpc)
            out, aux_o = self._gather_out(n, out, aux_o)
            per = losses.d_fake_loss(self.family, out, "none")
            if self.d_fake_aux:
                per = per + self._aux_batch(aux_o, yg, fake=True, reduction="none")
            loss = torch.sum(per if valid is None else per * valid)
            grads = torch.autograd.grad(loss, [p[k] for k in self.d_leaves])
        return dict(zip(self.d_leaves, grads)), out.detach()

    def _real_sum_grads(self, d_params: Params, x, y, n: Optional[int] = None, yg=None):
        """Plain summed grads of the per-sample real loss (non-private); this
        rank's share under a data axis, as in ``_fake_sum_grads``."""
        n = x.shape[0] if n is None else n
        yg = y if yg is None else yg
        p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        with torch.enable_grad():
            out, aux_o = self._d_apply(p, x, y)
            out, aux_o = self._gather_out(n, out, aux_o)
            loss = losses.d_real_loss(self.family, out, "sum") + self._aux_batch(
                aux_o, yg, fake=False, reduction="sum")
            grads = torch.autograd.grad(loss, [p[k] for k in self.d_leaves])
        return (dict(zip(self.d_leaves, grads)), out.detach(),
                None if aux_o is None else aux_o.detach())

    def d_step(self, state: TrainState, x, y, z,
               noise: Optional[List[torch.Tensor]], use_dp: bool, fake=None):
        """One D update of the vanilla model: the gc step (``d_step_gc``) or,
        without DP, plain summed grads; then /bs and Adam. ``fake``, when
        given, replaces the G forward on z (the grouped runner's batched
        fakes: this rank's rows under a data axis, as in every D step).
        Returns (state, metrics)."""
        if use_dp:
            return self.d_step_gc(state, x, y, z, noise=noise, fake=fake)
        b, yg = x.shape[0], y
        x, y, z = self._rows(x, y, z)
        fake = self.fakes(state.g_params, z, y) if fake is None else fake
        summed, r_out, r_aux = self._real_sum_grads(state.d_params, x, y, b, yg)
        fake_grads, f_out = self._fake_sum_grads(state.d_params, fake, y, n=b, yg=yg)
        total = self._reduce({k: summed[k] + fake_grads[k] for k in self.d_leaves})
        grads = {k: total[k] / b for k in self.d_leaves}
        return self._apply_d(state, grads), self._d_metrics(r_out, r_aux, f_out, yg)

    def _apply_d(self, state: TrainState, grads: Params) -> TrainState:
        d_params, d_mu, d_nu = _adam_all(
            state.d_params, grads, state.d_mu, state.d_nu, state.d_count + 1,
            self.opt.d_lr, self.opt.adam_b1, self.opt.adam_b2, wd=self.weight_decay,
            shard=self._adam_shard("d"))
        return replace(state, d_params=d_params, d_mu=d_mu, d_nu=d_nu,
                       d_count=state.d_count + 1)

    def _d_metrics(self, r_out, r_aux, f_out, y, stats=None, pen_value=None, valid=None):
        """The D step's metrics (JAX steps.py ``_d_metrics``); the aux
        columns exist exactly when the run has an aux loss (ACGAN, WCGAN),
        the accuracy then being of the head's argmax (0 without a head).
        With a Poisson mask ``valid`` the losses and accuracies are means
        over the valid rows (JAX steps.py:450-460, 848-863)."""
        if valid is None:
            r_loss = losses.d_real_loss(self.family, r_out)
            f_loss = losses.d_fake_loss(self.family, f_out)

            def vmean(t):
                return t.to(torch.float32).mean()
        else:
            count = torch.clamp(valid.sum(), min=1.0)

            def vmean(t):
                return torch.sum(valid * t.reshape(valid.shape[0], -1).to(torch.float32)
                                 .mean(dim=-1)) / count
            r_loss = vmean(losses.d_real_loss(self.family, r_out, "none"))
            f_loss = vmean(losses.d_fake_loss(self.family, f_out, "none"))
        m = {"d_adv_loss": r_loss + f_loss, "d_real_loss": r_loss,
             "d_fake_loss": f_loss,
             "d_real_acc": 100.0 * vmean(r_out > 0),
             "d_fake_acc": 100.0 * vmean(f_out < 0)}
        if self.use_aux:
            if valid is None:
                aux_loss = self._aux_batch(r_aux, y, fake=False)
            else:
                pa = self._aux_batch(r_aux, y, fake=False, reduction="none")
                aux_loss = vmean(pa) if isinstance(pa, torch.Tensor) else 0.0
            m["d_real_aux_loss"] = torch.as_tensor(aux_loss, device=r_out.device)
            m["d_real_aux_acc"] = torch.zeros((), device=r_out.device) if r_aux is None \
                else 100.0 * vmean(_acc_vs_max(r_aux, one_hot(y, self.n_classes)))
        if stats is not None:
            m.update(norm_mean=stats.norm_mean, norm_std=stats.norm_std,
                     norm_max=stats.norm_max, frac_clipped=stats.frac_clipped)
        if pen_value is not None:
            m["penalty"] = pen_value
        return m

    # ---------------- G step ----------------

    def g_step(self, state: TrainState, z, y_onehot):
        """G update of the vanilla model against the (already updated) D:
        mean BCE-vs-ones [+ ACGAN aux CE] (JAX _g_step); ``y_onehot`` is
        None when unconditional. Under DP with ``--backprop_clip`` (and
        ``--bpc_during_g_train``, the default) D runs clipped here too.
        Returns (state, metrics)."""
        n = z.shape[0]
        yg = None if y_onehot is None else torch.argmax(y_onehot, dim=1)
        z, y = self._rows(z, yg)
        p = {k: v.detach().requires_grad_(True) for k, v in state.g_params.items()}
        with torch.enable_grad():
            img = self._g_apply(p, z, y)
            out, aux_o = self._d_apply(state.d_params, img, y, bpc=self.bpc_g and self.opt.use_dp)
            out, aux_o = self._gather_out(n, out, aux_o)
            adv = losses.g_adv_loss(self.family, out)
            loss = adv
            if self.is_acgan:
                aux = self._aux_batch(aux_o, yg, fake=False)
                loss = adv + aux
            grads = torch.autograd.grad(loss, [p[k] for k in G_LEAVES])
        grads = self._reduce(dict(zip(G_LEAVES, grads)))
        g_params, g_mu, g_nu = _adam_all(
            state.g_params, grads, state.g_mu, state.g_nu, state.g_count + 1,
            self.opt.g_lr, self.opt.adam_b1, self.opt.adam_b2, shard=self._adam_shard("g"))
        m = {"g_adv_loss": adv.detach()}
        if self.is_acgan:
            m["g_aux_loss"] = torch.as_tensor(aux, device=z.device).detach()
            m["g_aux_acc"] = torch.zeros((), device=z.device) if aux_o is None \
                else 100.0 * _acc_vs_max(aux_o.detach(), y_onehot).mean()
        return replace(state, g_params=g_params, g_mu=g_mu, g_nu=g_nu,
                       g_count=state.g_count + 1), m

    # ---------------- penalty and fakes ----------------

    def row_weights(self, y: torch.Tensor, valid=None) -> Optional[torch.Tensor]:
        """Per-row 1 / count of the row's class in the batch, for the ACGAN
        wasserstein aux loss (JAX steps.py _row_weights); with a Poisson
        mask the counts run over the valid rows only."""
        if not (self.use_aux and self.aux_type == "wasserstein"):
            return None
        onehot = torch.nn.functional.one_hot(y.long(), self.n_classes).float()
        if valid is not None:
            onehot = onehot * valid[:, None]
        return 1.0 / torch.clamp(onehot @ onehot.sum(dim=0), min=1.0)

    def _penalty_grads(self, d_params: Params, pen_x, pen_y, fake, alphas,
                       pen_kw: Optional[dict] = None):
        """(value, grads by name) of the gradient penalty on the public /
        mean-sample batch, or the real batch under ``-pupd false`` outside
        gc (JAX steps.py _penalty_grads); ``alphas`` holds each penalty's
        draw (``penalty.draw_shape``). Under a data axis the inputs are this
        rank's rows and ``pen_kw`` is ``_pen_kw`` of the whole batch: the
        value is the whole batch's, the grads this rank's share."""
        p = {k: v.detach().requires_grad_(True) for k, v in d_params.items()}
        with torch.enable_grad():
            val = penalty_mod.calc_penalty(
                lambda xx, yy: self._d_apply(p, xx, yy), self.penalty_types, pen_x, pen_y,
                fake, alphas,
                aux_penalty=self.aux_penalty, n_classes=self.n_classes, **(pen_kw or {}))
            # The input gradient does not depend on the head biases: their
            # penalty gradient is zero.
            grads = torch.autograd.grad(val, [p[k] for k in self.d_leaves],
                                        allow_unused=True)
        return val.detach(), {k: torch.zeros_like(p[k]) if g is None else g
                              for k, g in zip(self.d_leaves, grads)}

    def fakes(self, g_params: Params, z, y):
        """Fresh fakes for a D step: a G forward without autograd."""
        with torch.no_grad():
            return self._g_apply(g_params, z, y)

    def _step_fakes(self, state: TrainState, z, y):
        """(fakes, G batch statistics after them) of a D step: a BatchNorm G
        runs in training mode and updates its running averages, as the JAX
        package's ``_fake_images`` does."""
        if not self.g_has_bn:
            return self.fakes(state.g_params, z, y), state.g_batch_stats
        stats = {k: v.clone() for k, v in state.g_batch_stats.items()}
        with torch.no_grad():
            img = self._g_apply({**state.g_params, **stats}, z, y, train=True)
        return img, stats

    def _fakes_or(self, state: TrainState, z, y, fake):
        """``_step_fakes``, or the given fakes (the grouped runner's, of a
        BatchNorm-free G) with the batch statistics unchanged."""
        if fake is None:
            return self._step_fakes(state, z, y)
        return fake, state.g_batch_stats

    def batch_fakes(self, state: TrainState, z_steps: torch.Tensor,
                    y_steps: Optional[torch.Tensor]) -> torch.Tensor:
        """Fresh fakes for m consecutive D steps in ONE G forward
        (``--group_fakes``; JAX ``batch_fakes``, steps.py:360-390): G's
        params change only at n_d_steps cadence points, so the m steps of a
        cadence group see one G, and their m batches run as one m * bs
        forward (through K4 on the card for the DCResNet G). ``z_steps``
        [m, bs, latent] are the per-step z the per-batch path draws,
        ``y_steps`` [m, bs] their labels or None. Returns [m, bs, ...];
        slice j equals the step's own forward up to the reduction order of
        the batched convolutions. A BatchNorm G is refused: its batch
        statistics depend on the batch. Under a data axis only this rank's
        rows of each step are made: [m, rows, ...]."""
        if self.g_has_bn:
            raise ValueError("batch_fakes requires a BatchNorm-free G")
        lo, hi = self.mesh.bounds(z_steps.shape[1])
        z_steps = z_steps[:, lo:hi]
        y_steps = None if y_steps is None else y_steps[:, lo:hi]
        m, bs = z_steps.shape[0], z_steps.shape[1]
        yf = None if y_steps is None else y_steps.reshape(m * bs)
        fakes = self.fakes(self.step_params(state).g_params, z_steps.reshape(m * bs, -1), yf)
        return fakes.reshape((m, bs) + tuple(fakes.shape[1:]))

    def grouped_runner_ok(self, use_dp: bool) -> bool:
        """Whether the cadence-grouped runner (``--group_fakes``) applies:
        n_d_steps > 1, no Poisson subsampling under DP, a BatchNorm-free G
        (JAX ``grouped_runner_ok``, steps.py:1114-1125). The runner takes it
        only for segments that start on a cadence point."""
        return (bool(self.opt.group_fakes) and int(self.opt.n_d_steps) > 1
                and not (self.poisson and use_dp) and not self.g_has_bn)

    def sample_images(self, state: TrainState, z, y):
        """Images of G at `state` for z and labels y (JAX ``sample_images``,
        steps.py:1129-1140): the G forward without autograd in eval mode (a
        BatchNorm G normalizes by its running averages), fp32 NHWC. The
        DCResNet G's GroupNorms run K4 on the card. The params are whole
        (``full_params``): the forward takes no tensor axis."""
        with torch.no_grad():
            if self.g_has_bn:
                return functional_call(self.G, {**state.g_params, **state.g_batch_stats},
                                       (z, y), {"train": False}).float()
            return functional_call(self.G, state.g_params, (z, y)).float()

    # ---------------- the gc D step ----------------

    def _d_apply(self, d_params: Params, x, y, aux: bool = True, bpc: bool = False):
        """D's (out, aux_out) on x; the labels reach D only when the run is
        conditional, and ``bpc`` only under ``--backprop_clip`` (JAX
        steps.py ``_d_apply``)."""
        kw = {"aux": aux}
        if self.use_bpc:
            kw["bpc"] = bpc
        if self._tp is not None:
            kw["mesh"] = self._tp
        return functional_call(self.D, d_params, (x, y if self.conditional else None), kw)

    def _aux_single(self, aux_row, yi, wi):
        """Aux loss of ONE sample (aux_row: [n_classes]), the per-sample form
        of models/losses.aux_loss (JAX steps.py ``_aux_single``); ``wi`` is the
        sample's 1 / count of its class in the batch. Zero for WCGAN."""
        if not self.use_aux or aux_row is None or self.arch == "WCGAN":
            return 0.0
        onehot = one_hot(yi, self.n_classes)
        if self.aux_type == "cross_entropy":
            return -self.aux_scalar * torch.sum(onehot * torch.log_softmax(aux_row, dim=-1))
        sign = onehot * -2.0 + 1.0
        return self.aux_scalar * torch.sum(sign * torch.sigmoid(aux_row)) * wi

    def _ps_penalty_one(self, d_params: Params, xi, yi, fi, draws_i):
        """The penalty of ONE (real, fake) pair, a term of that sample's
        clipped loss under ``-pupd false`` (JAX ``_ps_penalty_one``; reference
        train.py:438-450): calc_penalty on the one-row batch, each penalty's
        draw the sample's row of it, DRAGAN's std that of the row."""
        yy = None if yi is None else yi[None]
        return penalty_mod.calc_penalty(
            lambda xx, yl: self._d_apply(d_params, xx, yl), self.penalty_types, xi[None], yy,
            fi[None], [d[None] for d in draws_i], aux_penalty=self.aux_penalty,
            n_classes=self.n_classes)

    def real_ps_args(self, x, y, row_w, fake=None, ps_draws=None):
        """(loss_fn, batch args) of the per-sample REAL pass through the
        backprop-clipped D under ``--backprop_clip`` (JAX steps.py
        ``_real_ps_args``): loss_fn(d_params, x_i, y_i, w_i) is the real
        loss of one sample, or loss_fn(d_params, x_i) when unconditional.
        With ``ps_draws`` (the per-sample penalty: one [B, ...] draw per
        penalty) each sample's loss adds its penalty on (x_i, fake_i), and
        the batch args end with the fakes and the draws."""
        pen = () if ps_draws is None else (fake,) + tuple(ps_draws)

        def with_pen(loss, d_params, xi, yi, rest):
            return loss + self._ps_penalty_one(d_params, xi, yi, rest[0], rest[1:]) \
                if rest else loss

        if not self.conditional:
            def f_unc(d_params, xi, *rest):
                out, _ = self._d_apply(d_params, xi[None], None, bpc=True)
                return with_pen(losses.d_real_loss(self.family, out, "none")[0], d_params,
                                xi, None, rest)

            return f_unc, (x,) + pen
        w = row_w if row_w is not None else torch.ones(x.shape[0], device=x.device)

        def f(d_params, xi, yi, wi, *rest):
            out, aux_o = self._d_apply(d_params, xi[None], yi[None], bpc=True)
            loss = losses.d_real_loss(self.family, out, "none")[0]
            loss = loss + self._aux_single(None if aux_o is None else aux_o[0], yi, wi)
            return with_pen(loss, d_params, xi, yi, rest)

        return f, (x, y, w) + pen

    def combined_ps_args(self, x, y, fake, row_w, ps_draws=None):
        """(loss_fn, batch args) for real + fake clipped together
        (--grad_clip_split false, and tm / sv; JAX steps.py
        ``_combined_ps_args``), through the backprop-clipped D under
        ``--backprop_clip``; with ``ps_draws`` each sample's loss adds its
        penalty, and the batch args end with the draws."""
        pen = () if ps_draws is None else tuple(ps_draws)
        if not self.conditional:
            def f_unc(d_params, xi, fi, *draws):
                r_out, _ = self._d_apply(d_params, xi[None], None, bpc=True)
                f_out, _ = self._d_apply(d_params, fi[None], None, bpc=True)
                loss = losses.d_real_loss(self.family, r_out, "none")[0] \
                    + losses.d_fake_loss(self.family, f_out, "none")[0]
                if draws:
                    loss = loss + self._ps_penalty_one(d_params, xi, None, fi, draws)
                return loss

            return f_unc, (x, fake) + pen
        w = row_w if row_w is not None else torch.ones(x.shape[0], device=x.device)

        def f(d_params, xi, yi, fi, wi, *draws):
            r_out, r_aux = self._d_apply(d_params, xi[None], yi[None], bpc=True)
            f_out, f_aux = self._d_apply(d_params, fi[None], yi[None], aux=self.d_fake_aux,
                                         bpc=True)
            loss = losses.d_real_loss(self.family, r_out, "none")[0] \
                + losses.d_fake_loss(self.family, f_out, "none")[0]
            loss = loss + self._aux_single(None if r_aux is None else r_aux[0], yi, wi)
            if self.d_fake_aux:
                loss = loss + self._aux_single(None if f_aux is None else f_aux[0], yi, wi)
            if draws:
                loss = loss + self._ps_penalty_one(d_params, xi, yi, fi, draws)
            return loss

        return f, (x, y, fake, w) + pen

    def poisson_pack(self, incl: torch.Tensor):
        """(row indices [cap], validity mask [cap] fp32) of one Poisson draw
        from its inclusion vector [N] bool: the included rows first, each
        part in row order (a stable sort), the mask 1 on the included ones
        (JAX ``poisson_draw``, steps.py:615-627)."""
        order = torch.argsort((~incl).to(torch.int32), stable=True)
        count = incl.sum()
        valid = (torch.arange(self.poisson_cap, device=incl.device) < count).to(torch.float32)
        return order[:self.poisson_cap], valid

    def poisson_draw(self, gen: torch.Generator, n_rows: int):
        """One exact Poisson draw over ``n_rows`` rows: Bernoulli(B / N)
        inclusion from ``gen`` on its device, packed by ``poisson_pack``."""
        incl = torch.rand(n_rows, generator=gen, device=gen.device) < self.poisson_q
        return self.poisson_pack(incl)

    def adaptive_clipping(self, d_params: Params, ax, ay) -> torch.Tensor:
        """New clipping thresholds from the per-sample gradient norms of the
        real loss on the public or mean-sample batch (ax, ay) (JAX
        ``_adaptive_clipping``, steps.py:690-716): the conv-ghost norms of
        the DCResNet D (K2 on the card for its ghost-order layers), else the
        norms of the materialized per-sample gradients. Their mean or max
        over the batch (``--adaptive_stat``) times ``--adaptive_scalar``: an
        fp32 [n_leaves] tensor per layer, the l2 of that vector otherwise.
        Under a data axis each rank takes the norms of its rows of (ax, ay)
        and the statistic is over the gathered norms of the whole batch."""
        row_w = self.row_weights(ay) if self.conditional else None
        n = ax.shape[0]
        ax, ay, row_w = self._rows(ax, ay, row_w)
        if self.use_conv_ghost:
            norms = conv_ghost.dcresnet_real_ghost(
                d_params, ax, ay, n_classes=self.n_classes, arch=self.arch,
                aux_type=self.aux_type, aux_scalar=self.aux_scalar, row_w=row_w,
                max_norm=1.0, per_layer=self.per_layer, concat_planes=self.concat_planes,
                compute_dtype=self.compute_dtype, norms_only=True, mesh=self._tp,
                sharded=self.d_sharded)
        else:
            f, args = self.real_ps_args(ax, ay, row_w)
            norms = gops.leaf_norms(gops.per_sample_grads(f, d_params, *args, chunk=self.chunk),
                                    self.sq_reduce)
        norms = self.mesh.gather_cols(norms, n)
        stat = norms.mean(dim=1) if self.adaptive_stat == "mean" else norms.amax(dim=1)
        if self.per_layer:
            return stat * self.adaptive_scalar
        return torch.sqrt(torch.sum(stat ** 2)) * self.adaptive_scalar

    def clipping_tensor(self, clipping, device: torch.device) -> torch.Tensor:
        """``clipping`` as an fp32 tensor on ``device``; constant thresholds
        are copied to the device once."""
        if isinstance(clipping, torch.Tensor):
            return clipping
        key = (clipping, str(device))
        if key not in self._clip_consts:
            self._clip_consts[key] = torch.tensor(clipping, dtype=torch.float32, device=device)
        return self._clip_consts[key]

    def d_step_gc(self, state: TrainState, x, y, z,
                  noise: Optional[List[torch.Tensor]] = None,
                  fused: Optional[gops.FusedNoise] = None,
                  pen_x=None, pen_y=None,
                  alphas: Optional[List[torch.Tensor]] = None, ax=None, ay=None,
                  valid: Optional[torch.Tensor] = None,
                  ps_draws: Optional[List[torch.Tensor]] = None, fake=None):
        """One gc D update (JAX ``_d_step_gc``): under adaptive clipping the
        step's thresholds from (ax, ay) (``adaptive_clipping``), then the
        clipped private pass by the route the config selects (see the module
        docstring), the clean fake pass [+ b * penalty grads], the DP noise,
        then /b and Adam.

        With a Poisson mask ``valid`` ([b] fp32) masked rows add nothing to
        either pass or to the metrics, and the division and the penalty's
        scale are by the expected batch ``--batch_size``. Under the per-sample
        penalty (``self.ps_pen``) ``ps_draws`` holds each penalty's [b, ...]
        draw: each sample's penalty is inside its clipped loss, and the batch
        penalty on (pen_x, pen_y) with ``alphas`` is computed for the log
        only.

        The noise is either ``noise``, per-leaf draws in leaf order that are
        added to the sum, or, on the fused route (``self.fused_route``),
        ``fused``: per-leaf seeds for K6 and normals for the small leaves.
        Under adaptive clipping ``noise`` holds N(0, 1) draws, and both kinds
        are scaled on the device by this step's stds sigma * C (``fused.stds``
        is replaced). Returns (state, metrics); the metrics' ``clipping`` is
        the step's thresholds as a device tensor, and an adaptive step puts
        them into the new state.

        Under a data axis every input is the whole batch's, the same on all
        ranks, but ``fake`` (this rank's rows); the step keeps this rank's
        rows, reduces the clipped, fake-pass and penalty sums, and only the
        ranks of data index 0 add the noise (the others pass K6 a zero std).
        Under a model axis those ranks add each their slices' part of the
        one-device draw (``_model_cut``, ``_local_fused``)."""
        if (fused is None) == (noise is None) or (fused is not None) != self.fused_route:
            raise ValueError("d_step_gc takes per-leaf noise, or fused noise exactly "
                             "on the fused route (--pallas true, materialized)")
        if self.ps_pen and ps_draws is None:
            raise ValueError("the per-sample penalty (-pupd false) takes ps_draws")
        b = x.shape[0]
        b_eff = self.opt.batch_size if valid is not None else b
        d_params, clipping = state.d_params, state.clipping
        stds = None
        if self.adaptive:
            clipping = self.adaptive_clipping(d_params, ax, ay)
            stds = (clipping * self.sigma).expand(len(self.d_leaves))
            if fused is not None:
                fused = fused._replace(stds=stds.contiguous())
        if fused is not None and self.mesh.data_index != 0:
            # The noise enters once: the other ranks give K6 a zero std.
            fused = fused._replace(stds=torch.zeros_like(fused.stds))
        fused = self._local_fused(fused)
        add_noise = noise is not None and self.mesh.data_index == 0
        if add_noise and self._tp is not None:
            noise = [self._model_cut(k, e) for k, e in zip(self.d_leaves, noise)]
        row_w = self.row_weights(y, valid)
        yg, vg = y, valid
        pen_kw = self._pen_kw(pen_x)
        x, y, z, valid, row_w, pen_x, pen_y, alphas, ps_draws = self._rows(
            x, y, z, valid, row_w, pen_x, pen_y, alphas, ps_draws)
        sg = self._stats_gather(b)
        fake = self.fakes(state.g_params, z, y) if fake is None else fake
        ghost_outs = None
        if self.grad_clip_split:
            # Private real pass: per-sample clip; clean fake pass: summed grads.
            if self.use_ghost and not self.ps_pen:
                cond = self.conditional
                summed, stats, ghost_outs = ghost.vanilla_real_ghost(
                    d_params, x, one_hot(y, self.n_classes) if cond else None,
                    y if cond and self.use_aux else None,
                    self.aux_scalar, clipping, self.per_layer, valid=valid, stats_gather=sg,
                    mesh=self._tp, sharded=self.d_sharded)
            elif self.use_conv_ghost and not self.ps_pen:
                summed, stats, ghost_outs = conv_ghost.dcresnet_real_ghost(
                    d_params, x, y, n_classes=self.n_classes, arch=self.arch,
                    aux_type=self.aux_type, aux_scalar=self.aux_scalar, row_w=row_w,
                    max_norm=clipping, per_layer=self.per_layer,
                    concat_planes=self.concat_planes, compute_dtype=self.compute_dtype,
                    valid=valid, stats_gather=sg, mesh=self._tp, sharded=self.d_sharded)
            elif self.use_two_pass and not self.ps_pen:
                f, args = gops.mask_loss(*self.real_ps_args(x, y, row_w), valid)
                summed, stats = gops.two_pass_clipped_grad_sum(
                    f, d_params, *args, max_norm=clipping, per_layer=False, stats_gather=sg,
                    sq_reduce=self.sq_reduce)
            else:
                f, args = gops.mask_loss(*self.real_ps_args(x, y, row_w, fake, ps_draws), valid)
                summed, stats = gops.clipped_grad_sum(
                    f, d_params, *args, max_norm=clipping, per_layer=self.per_layer,
                    chunk=self.chunk, fused_noise=fused, stats_gather=sg,
                    sq_reduce=self.sq_reduce)
            fake_grads, f_out = self._fake_sum_grads(d_params, fake, y, vg, bpc=True, n=b,
                                                     yg=yg)
        else:
            f, args = gops.mask_loss(*self.combined_ps_args(x, y, fake, row_w, ps_draws), valid)
            summed, stats = gops.clipped_grad_sum(
                f, d_params, *args, max_norm=clipping, per_layer=self.per_layer,
                chunk=self.chunk, fused_noise=fused, stats_gather=sg, sq_reduce=self.sq_reduce)
            fake_grads = None
            with torch.no_grad():
                f_out = self._d_apply(d_params, fake, y, aux=False)[0]
        if add_noise and stds is not None:
            summed = dict(zip(self.d_leaves, gops.add_scaled_noise(
                [summed[k] for k in self.d_leaves], noise, stds)))
        elif add_noise:
            summed = {k: summed[k] + noise[i] for i, k in enumerate(self.d_leaves)}
        total = summed if fake_grads is None else \
            {k: summed[k] + fake_grads[k] for k in self.d_leaves}
        pen_value = None
        if self.ps_pen:
            # Clipped inside the per-sample losses; the batch value is
            # recomputed for the log only.
            with torch.no_grad():
                pen_value = penalty_mod.calc_penalty(
                    lambda xx, yy: self._d_apply(d_params, xx, yy), self.penalty_types,
                    pen_x, pen_y, fake, alphas, aux_penalty=self.aux_penalty,
                    n_classes=self.n_classes, **pen_kw)
        elif self.penalty_types:
            pen_value, pen_grads = self._penalty_grads(d_params, pen_x, pen_y, fake, alphas,
                                                       pen_kw)
            total = {k: t + pen_grads[k] * b_eff for k, t in total.items()}
        total = self._reduce(total)
        grads = {k: t / b_eff for k, t in total.items()}

        if ghost_outs is not None:
            r_out, r_aux = ghost_outs
        else:
            with torch.no_grad():
                r_out, r_aux = self._d_apply(d_params, x, y)
        if fake_grads is None:
            r_out, r_aux, f_out = self._gather_out(b, r_out, r_aux, f_out)
        else:
            r_out, r_aux = self._gather_out(b, r_out, r_aux)
        metrics = self._d_metrics(r_out, r_aux, f_out, yg, stats, pen_value, vg)
        metrics["clipping"] = self.clipping_tensor(clipping, x.device)
        new = self._apply_d(state, grads)
        if self.adaptive:
            new = replace(new, clipping=clipping)
        return new, metrics

    def d_step_conv_ghost(self, state: TrainState, x, y, z,
                          noise: List[torch.Tensor], pen_x=None, pen_y=None,
                          alphas: Optional[List[torch.Tensor]] = None):
        """``d_step_gc`` with per-leaf noise, by its earlier name."""
        return self.d_step_gc(state, x, y, z, noise=noise, pen_x=pen_x, pen_y=pen_y,
                              alphas=alphas)

    # ---------------- the is, tm/sv and non-private D steps ----------------

    def _full_batch_loss(self, d_params: Params, x, y, fake, bpc: bool = False,
                         n: Optional[int] = None, yg=None):
        """The full-batch D loss of JAX ``_d_step_plain`` / ``_d_step_is``
        without the penalty: mean real and fake losses, the real aux loss and,
        with ``--d_fake_aux_loss``, the fake's; through the backprop-clipped
        D with ``bpc`` (the is step). Under a data axis x, y and fake are
        this rank's rows and ``n``, ``yg`` the whole batch's count and
        labels: D's outputs are gathered and the loss is the whole batch's.
        Returns (loss, r_out, r_aux, f_out), the outputs the whole batch's."""
        n = x.shape[0] if n is None else n
        yg = y if yg is None else yg
        f_out, f_aux = self._d_apply(d_params, fake, y, aux=self.d_fake_aux, bpc=bpc)
        r_out, r_aux = self._d_apply(d_params, x, y, bpc=bpc)
        f_out, f_aux, r_out, r_aux = self._gather_out(n, f_out, f_aux, r_out, r_aux)
        total = losses.d_real_loss(self.family, r_out) + losses.d_fake_loss(self.family, f_out)
        total = total + self._aux_batch(r_aux, yg, fake=False)
        if self.d_fake_aux:
            total = total + self._aux_batch(f_aux, yg, fake=True)
        return total, r_out, r_aux, f_out

    def _metrics_of(self, r_out, r_aux, f_out, y, pen_value):
        return self._d_metrics(r_out.detach(), None if r_aux is None else r_aux.detach(),
                               f_out.detach(), y, pen_value=pen_value)

    def d_step_plain(self, state: TrainState, x, y, z, pen_x=None, pen_y=None,
                     alphas: Optional[List[torch.Tensor]] = None, fake=None):
        """The non-private D update (JAX ``_d_step_plain``): the gradient of
        the full-batch loss plus the penalty on (pen_x, pen_y) and the fakes,
        then Adam. Returns (state, metrics)."""
        n, yg = x.shape[0], y
        pen_kw = self._pen_kw(pen_x)
        x, y, z, pen_x, pen_y, alphas = self._rows(x, y, z, pen_x, pen_y, alphas)
        fake, g_stats = self._fakes_or(state, z, y, fake)
        state = replace(state, g_batch_stats=g_stats)
        p = {k: v.detach().requires_grad_(True) for k, v in state.d_params.items()}
        pen_value = None
        with torch.enable_grad():
            total, r_out, r_aux, f_out = self._full_batch_loss(p, x, y, fake, n=n, yg=yg)
            if self.penalty_types:
                pen_value = penalty_mod.calc_penalty(
                    lambda xx, yy: self._d_apply(p, xx, yy), self.penalty_types,
                    pen_x, pen_y, fake, alphas, aux_penalty=self.aux_penalty,
                    n_classes=self.n_classes, **pen_kw)
                total = total + pen_value
            grads = torch.autograd.grad(total, [p[k] for k in self.d_leaves])
        metrics = self._metrics_of(r_out, r_aux, f_out, yg,
                                   None if pen_value is None else pen_value.detach())
        return self._apply_d(state, self._reduce(dict(zip(self.d_leaves, grads)))), metrics

    def sensitivity(self, g: List[torch.Tensor], x_in: torch.Tensor, scaling_vec):
        """(sens, per-leaf stds) of the is step from its gradient ``g`` (with
        its graph) and the input it was taken at: ||d ||g|| / dx|| (flat);
        ||d s / dx|| with s = ||(||g_l|| / v_l)_l|| and stds sigma sens v
        (scaling modes); or, per parameter, ||d ||g_l|| / dx|| for each leaf
        in one batched backward (a one-hot cotangent per leaf). The flat norm
        is the global norm of g, as in the JAX step: a leaf whose gradient is
        exactly 0 (lin2.bias under backprop clipping, when the clipped real
        and fake cotangents cancel) then has no square root to differentiate
        at 0. Under a data axis x_in is this rank's rows and g the reduced
        gradient (``sum_replicated``): the squares of the input gradient are
        summed over the ranks. Under a model axis g holds this rank's slices
        of the sharded leaves, whose squares are summed over the model group
        inside the differentiated norms (``_sq_reduce``, identity backward);
        the input gradient is then whole on every model rank (x_in enters D
        through ``copy_model``, whose backward sums over the model group), so
        its squares are summed over the data group only."""
        n = len(g)
        if self.is_per_param:
            norms, eye = gops.per_leaf_norms(g, self.sq_reduce), torch.eye(n, device=x_in.device)
            if self._tp is None:
                gx, = torch.autograd.grad(norms, x_in, eye, is_grads_batched=True)
            else:
                # is_grads_batched's vmap cannot run the model axis's
                # collectives; torch.func.vmap takes their vmap rules.
                gx, = torch.func.vmap(lambda v: torch.autograd.grad(
                    norms, x_in, v, retain_graph=True))(eye)
            sens = torch.sqrt(self.mesh.all_sum(
                torch.sum(gx.reshape(n, -1).float() ** 2, dim=1)))
            return sens, self.sigma * sens
        scaled = self.is_scaling_mode != "standard"
        s = torch.sqrt(torch.sum((gops.per_leaf_norms(g, self.sq_reduce) / scaling_vec) ** 2)) \
            if scaled else gops.global_norm(g, self.sq_reduce)
        gx, = torch.autograd.grad(s, x_in)
        sens = torch.sqrt(self.mesh.all_sum(torch.sum(gx.float() ** 2)))
        return sens, self.sigma * sens * scaling_vec if scaled else (self.sigma * sens).expand(n)

    def d_step_is(self, state: TrainState, x, y, z, eps: List[torch.Tensor],
                  pen_x=None, pen_y=None, alphas: Optional[List[torch.Tensor]] = None,
                  fake=None):
        """One immediate-sensitivity D update (JAX ``_d_step_is``); ``eps``
        are N(0, 1) draws shaped like the leaves, in leaf order, scaled here
        by the step's stds on the device. The penalty's gradient enters ||g||
        as a constant, taken without a graph. Its inputs are mean samples or
        public rows and the fakes, or under ``-pupd false`` the real batch
        itself: the JAX package's step also closes over that batch as a
        constant (its ``pen_x``, not the differentiated ``x_in``), so the
        sensitivity leaves out the penalty's dependence on the private batch
        in both packages (ROADMAP Queue 3). The same value as the JAX
        package's one differentiated loss, without a third-order graph. Under
        ``--backprop_clip`` D runs clipped in the loss and its
        second-order pass. Returns (state, metrics) with ``is_sens`` a
        scalar, or [n_leaves] under ``-ispp true``. Under a data axis the
        gradient g of this rank's rows is reduced by ``sum_replicated`` (every
        rank then differentiates the same ||g||, and the identity backward
        gives each its rows' input gradient); the noise, the same draw on
        every rank, goes onto the reduced g. Under a model axis g, the noise
        and the update are this rank's slices (``_model_cut`` of the whole
        draw), and the norms are the whole leaves' (``sensitivity``)."""
        n, yg = x.shape[0], y
        pen_kw = self._pen_kw(pen_x)
        x, y, z, pen_x, pen_y, alphas = self._rows(x, y, z, pen_x, pen_y, alphas)
        fake, g_stats = self._fakes_or(state, z, y, fake)
        state = replace(state, g_batch_stats=g_stats)
        leaves = self.d_leaves
        pen_value = None
        if self.penalty_types:
            pen_value, pen_grads = self._penalty_grads(state.d_params, pen_x, pen_y, fake, alphas,
                                                       pen_kw)
            pen_grads = self._reduce(pen_grads)
        p = {k: v.detach().requires_grad_(True) for k, v in state.d_params.items()}
        x_in = x.detach().requires_grad_(True)
        with torch.enable_grad():
            total, r_out, r_aux, f_out = self._full_batch_loss(p, x_in, y, fake, bpc=True, n=n,
                                                               yg=yg)
            g = list(torch.autograd.grad(total, [p[k] for k in leaves], create_graph=True))
            g = self.mesh.sum_replicated_list(g)
            if pen_value is not None:
                g = [gi + pen_grads[k] for gi, k in zip(g, leaves)]
            sens, stds = self.sensitivity(g, x_in, state.scaling_vec)
        eps = [self._model_cut(k, e) for k, e in zip(leaves, eps)]
        noised = gops.add_scaled_noise([gi.detach() for gi in g], eps, stds.detach())
        new = self._apply_d(state, dict(zip(leaves, noised)))
        if self.is_scaling_mode == "moving-avg-pl":
            norms = gops.per_leaf_norms(noised, self.sq_reduce)
            new = replace(new, scaling_vec=state.scaling_vec * self.moving_avg_beta
                          + norms * (1 - self.moving_avg_beta))
        metrics = self._metrics_of(r_out, r_aux, f_out, yg, pen_value)
        metrics["is_sens"] = sens.detach()
        return new, metrics

    def d_step_tmsv(self, state: TrainState, x, y, z, noise: List[torch.Tensor],
                    pen_x=None, pen_y=None, alphas: Optional[List[torch.Tensor]] = None,
                    fake=None):
        """One trimmed-mean (``-dpm tm``) or sign-vote (``-dpm sv``) D update
        (JAX ``_d_step_tmsv``): per-sample grads of real + fake, aggregated
        per leaf with ``noise`` (Student-t(3) for tm, N(0, 1) for sv, leaf
        order), plus the penalty's grads, then Adam. The metrics are of the
        D before the update. Under a data axis each rank takes the per-sample
        gradients of its rows: tm gathers them for its sort, sv sums its
        votes over the ranks. Under a model axis those are of this rank's
        slices (every coordinate's sort and vote are its own), with the
        slices' part of the whole noise draw. Returns (state, metrics)."""
        n, yg = x.shape[0], y
        pen_kw = self._pen_kw(pen_x)
        row_w = self.row_weights(y)
        x, y, z, row_w, pen_x, pen_y, alphas = self._rows(x, y, z, row_w, pen_x, pen_y, alphas)
        fake, g_stats = self._fakes_or(state, z, y, fake)
        state = replace(state, g_batch_stats=g_stats)
        f, args = self.combined_ps_args(x, y, fake, row_w)
        ps = gops.per_sample_grads(f, state.d_params, *args, chunk=self.chunk)
        noise = [self._model_cut(k, e) for k, e in zip(self.d_leaves, noise)]
        grads = {}
        if self.dp_mode == "tm":
            for i, k in enumerate(self.d_leaves):
                grads[k] = tmsv.trimmed_mean(self.mesh.gather_rows(ps[k], n), self.tm_m,
                                             self.tm_min_val, self.tm_max_val,
                                             self.smooth_sens_t, self.rho_per_step,
                                             noise=noise[i])
        else:
            votes = self.mesh.all_sum_list([tmsv.vote_sum(ps[k]) for k in self.d_leaves])
            for i, k in enumerate(self.d_leaves):
                grads[k] = tmsv.noisy_vote(votes[i], n, self.rho_per_step, noise=noise[i])
        del ps
        pen_value = None
        if self.penalty_types:
            pen_value, pen_grads = self._penalty_grads(state.d_params, pen_x, pen_y, fake, alphas,
                                                       pen_kw)
            pen_grads = self._reduce(pen_grads)
            grads = {k: g + pen_grads[k] for k, g in grads.items()}
        with torch.no_grad():
            r_out, r_aux = self._d_apply(state.d_params, x, y)
            f_out = self._d_apply(state.d_params, fake, y, aux=False)[0]
            r_out, r_aux, f_out = self._gather_out(n, r_out, r_aux, f_out)
        metrics = self._metrics_of(r_out, r_aux, f_out, yg, pen_value)
        return self._apply_d(state, grads), metrics

    def d_core(self, state: TrainState, x, y, z, use_dp: bool, noise=None, fused=None,
               pen_x=None, pen_y=None, alphas: Optional[List[torch.Tensor]] = None,
               ax=None, ay=None, valid=None, fake=None):
        """The D update by ``dp_mode`` (JAX ``_d_core``). ``noise`` is what
        the mode's step takes: per-leaf noise (gc; unit normals under
        adaptive clipping), unit normals (is), Student-t(3) or unit normals
        (tm / sv); ``fused`` the gc fused route's; (ax, ay) the adaptive
        clipping batch; ``valid`` the gc step's Poisson mask. Under the
        per-sample penalty the gc step takes the penalty's draws ``alphas``
        for its samples and for the logged batch value alike. Without DP the
        vanilla model takes ``d_step`` (the plain version of K1) unless it
        has a penalty, the DCResNet ``d_step_plain``. ``fake``, when given,
        replaces the step's G forward on z (the JAX ``_d_core``'s
        ``fake_img``: the grouped runner's batched fakes, this rank's rows).
        Under --fsdp the step runs on the whole params (under --tp on this
        rank's slices) and the new state holds this rank's blocks."""
        pen = dict(pen_x=pen_x, pen_y=pen_y, alphas=alphas, fake=fake)
        state = self.step_params(state)
        if use_dp and self.dp_mode == "gc":
            new, m = self.d_step_gc(state, x, y, z, noise=noise, fused=fused, ax=ax, ay=ay,
                                    valid=valid, ps_draws=alphas if self.ps_pen else None,
                                    **pen)
        elif use_dp and self.dp_mode == "is":
            new, m = self.d_step_is(state, x, y, z, noise, **pen)
        elif use_dp:
            new, m = self.d_step_tmsv(state, x, y, z, noise, **pen)
        elif self.family == "vanilla" and not self.penalty_types:
            new, m = self.d_step(state, x, y, z, None, False, fake=fake)
        else:
            new, m = self.d_step_plain(state, x, y, z, **pen)
        return self.shard_state(new), m

    def g_core(self, state: TrainState, z, y):
        """The G update of the model family on z and labels y (None when
        unconditional): ``g_step`` (one-hot labels) or ``g_step_dcresnet``;
        under --fsdp on the whole params (under --tp this rank's slices),
        the state's blocks updated."""
        state = self.step_params(state)
        if self.family == "vanilla":
            new, m = self.g_step(state, z, None if y is None else one_hot(y, self.n_classes))
        else:
            new, m = self.g_step_dcresnet(state, z, y)
        return self.shard_state(new), m

    def g_step_dcresnet(self, state: TrainState, z, y):
        """G update against the current D: wgan adversarial loss (a WCGAN
        critic's column y of its head) + the ACGAN aux loss (JAX _g_step);
        the GroupNorm+ReLU backward runs K5. A BatchNorm G trains on batch
        statistics and updates its running averages. Under a data axis G and
        D run on this rank's rows of z and y, D's outputs are gathered for
        the whole batch's loss, and the grads are reduced."""
        n, yg = z.shape[0], y
        z, y = self._rows(z, y)
        p = {k: v.detach().requires_grad_(True) for k, v in state.g_params.items()}
        stats = {k: v.clone() for k, v in state.g_batch_stats.items()}
        with torch.enable_grad():
            img = self._g_apply({**p, **stats}, z, y)
            out, aux_o = self._d_apply(state.d_params, img, y)
            out, aux_o = self._gather_out(n, out, aux_o)
            adv = losses.g_adv_loss(self.family, out)
            loss = adv
            if self.is_acgan:
                aux = self._aux_batch(aux_o, yg, fake=False)
                loss = adv + aux
            grads = torch.autograd.grad(loss, [p[k] for k in self.g_leaves])
        g_params, g_mu, g_nu = _adam_all(
            state.g_params, self._reduce(dict(zip(self.g_leaves, grads))), state.g_mu,
            state.g_nu, state.g_count + 1, self.opt.g_lr, self.opt.adam_b1,
            self.opt.adam_b2, shard=self._adam_shard("g"))
        m = {"g_adv_loss": adv.detach()}
        if self.is_acgan:
            m["g_aux_loss"] = torch.as_tensor(aux, device=z.device).detach()
            m["g_aux_acc"] = torch.zeros((), device=z.device) if aux_o is None \
                else 100.0 * (aux_o.detach().argmax(dim=1) == yg).float().mean()
        return replace(state, g_params=g_params, g_mu=g_mu, g_nu=g_nu,
                       g_count=state.g_count + 1, g_batch_stats=stats), m
