"""The runners that drive whole epochs: ``EpochsRunner`` (the MNIST vanilla
path, one K1 launch per epoch) and ``StepRunner`` (every other ported
configuration of either model, one D step at a time with a G update on the
n_d_steps cadence).

EpochsRunner:

For each epoch it draws, on the device and from the Trainer's generators, the
permutation of the table rows and every step's randomness (z_d, z_g, y_g and
the DP noise), in the order K1 consumes them (the JAX package pre-draws the
same way at ops/pallas_epoch.py:492-514), then calls ``epoch_kernel`` once.
Metric sums stay on the device; the caller reads them once per group.

The streams are torch's, so they differ from the JAX package's for the same
seed; value parity is tested with injected draws (tests/test_torch_epoch.py).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch

from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.models.mnist import D_LEAVES
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.ops import pallas_epoch, tmsv
from csl_gan_tpu_torch.privacy.mean_sampler import MeanSampler
from csl_gan_tpu_torch.training.steps import StepBuilder, TrainState


class EpochsRunner:
    def __init__(self, builder: StepBuilder, n_batches: int, use_dp: bool):
        self.builder = builder
        self.n = n_batches
        self.use_dp = use_dp
        # On CUDA: (start, end) events around each epoch (draws + kernel) of
        # the last run() call, for per-epoch device times.
        self.epoch_events: List[tuple] = []

    def draw(self, table: torch.Tensor, gen_perm: torch.Generator,
             gen: torch.Generator, state: TrainState):
        """One epoch's inputs: gathered rows, z_d, z_g, one_hot(y_g), noise."""
        b = self.builder
        bs, n = b.opt.batch_size, self.n
        perm = torch.randperm(table.shape[0], generator=gen_perm,
                              device=table.device)
        rows = table[perm[: n * bs]]
        z_d = b.gen_z(gen, bs, (n,))
        z_g = b.gen_z(gen, bs, (n,))
        ohg = one_hot(b.gen_y(gen, bs, (n,)), b.n_classes)
        noise: Optional[List[torch.Tensor]] = None
        if self.use_dp:
            noise = gops.noise_like(gen, [state.d_params[k] for k in D_LEAVES],
                                    gops.noise_std(b.sigma, state.clipping),
                                    lead=(n,))
        return rows, z_d, z_g, ohg, noise

    def run(self, state: TrainState, table: torch.Tensor,
            gen_perm: torch.Generator, gen: torch.Generator, k: int):
        """k epochs from `state`. Returns (state, metric sums [40] on device)."""
        met = torch.zeros(pallas_epoch.MET_SLOTS, dtype=torch.float32,
                          device=table.device)
        params, mu, nu = pallas_epoch.leaves_of(state)
        t = (state.d_count, state.g_count)
        timed = table.is_cuda
        self.epoch_events = []
        for _ in range(k):
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            rows, z_d, z_g, ohg, noise = self.draw(table, gen_perm, gen, state)
            params, mu, nu, m = pallas_epoch.epoch_kernel(
                self.builder, rows, z_d, z_g, ohg, noise, state.clipping, t,
                params, mu, nu, use_dp=self.use_dp)
            met += m
            t = (t[0] + self.n, t[1] + self.n)
            if timed:
                ev[1].record()
                self.epoch_events.append(ev)
        return pallas_epoch.state_from_leaves(params, mu, nu, state.clipping, t), met


class StepRunner:
    """k whole epochs, one D step at a time (the JAX package's
    segment_runner.py _build_run, written as a Python loop over steps): the
    D step of the config's ``dp_mode`` (training/steps.py ``d_core``: gc by
    the route the config selects, is, tm / sv, or without DP the model's
    plain D step); the G step of the model family.

    Per epoch it draws the row permutation from ``gen_perm``; per step, from
    ``gen`` and in this order: the horizontal flips (uint8 image tables),
    z_d, the DP noise (gc: per-leaf normals times the stds, or on the fused
    route the per-leaf seeds and then the small leaves' normals,
    ``ops/grads.draw_fused_noise``; is: one N(0, 1) draw sliced per leaf,
    which the step scales by its own stds on the device; tm: Student-t(3)
    per leaf; sv: N(0, 1) per leaf), the penalty batch (the mean-sample
    surrogates, or the real batch without mean samples) and the penalty's
    interpolation weights; on a G update, z_g and y_g. The G update follows
    the D steps i with i % n_d_steps == 0, gated while
    train_d_until_threshold < 1e10 by the mean D adversarial loss since the
    last cadence point (one host read per cadence point; none without
    gating). Metric sums stay on the device; the caller reads them once per
    group. Under ``-dpm is`` the sums also hold the run's least and largest
    ``is_sens`` (``is_sens_min`` / ``is_sens_max``, from +inf / -inf, kept
    on the device).

    ``gather(idx) -> (x, y)`` returns a batch's images and labels from the
    device-resident dataset; with ``u8_images`` the images are uint8 and get
    the JAX Trainer's ``/127.5 - 1`` and random flip after the gather. An
    unconditional run's steps take no labels (y None, the G step's too), and
    its penalty batch none either (JAX segment_runner.py:208-234).

    With ``on_sample`` set, ``on_sample(state, j, i)`` is called after batch i
    of the run's epoch j whenever ``(i + 1) * batch_size`` is a multiple of
    ``sample_every`` (the sub-epoch sample cadence, JAX loop.py:829-831).
    """

    def __init__(self, builder: StepBuilder, n_batches: int, n_rows: int,
                 gather: Callable, u8_images: bool,
                 mean_sampler: Optional[MeanSampler] = None,
                 mean_samples: Optional[torch.Tensor] = None):
        self.builder = builder
        self.n = n_batches
        self.n_rows = n_rows
        self.gather = gather
        self.u8_images = u8_images
        self.mean_sampler = mean_sampler
        self.mean_samples = mean_samples
        opt = builder.opt
        self.use_dp = bool(opt.use_dp)
        self.n_d = max(1, int(opt.n_d_steps))
        self.threshold = float(opt.train_d_until_threshold)
        # Running D adversarial-loss sum since the last cadence point; it
        # persists across run() calls, like the JAX runner's carry.
        self.d_acc = None
        self.epoch_events: List[tuple] = []
        self.on_sample: Optional[Callable] = None
        self.sample_every = int(opt.sample_every)

    def _batch(self, idx: torch.Tensor, gen: torch.Generator):
        x, y = self.gather(idx)
        if not self.builder.conditional:
            y = None
        if self.u8_images:
            flip = torch.rand(x.shape[0], generator=gen, device=x.device) < 0.5
            x = x.float() / 127.5 - 1.0
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        return x, y

    def _penalty_inputs(self, gen: torch.Generator, x: torch.Tensor,
                        y: Optional[torch.Tensor], bs: int):
        """The penalty's batch (the mean-sample surrogates, else the real
        batch, as the JAX runner picks it) and interpolation weights."""
        b = self.builder
        if not b.penalty_types:
            return None, None, None
        pen_x, pen_y = x, y
        if self.mean_sampler is not None:
            pen_x, pen_y = self.mean_sampler.device_sample(self.mean_samples, gen, y, bs)
            if not b.conditional:
                pen_y = None
        alphas = [torch.rand((bs, 1, 1, 1), generator=gen, device=x.device)
                  for _ in b.penalty_types]
        return pen_x, pen_y, alphas

    def _noise(self, gen: torch.Generator, leaves, stds):
        """(noise, fused) of one DP step, as the mode's D step takes them."""
        b = self.builder
        if b.dp_mode == "gc":
            if b.fused_route:
                return None, gops.draw_fused_noise(gen, leaves, stds)
            return gops.noise_like(gen, leaves, stds), None
        if b.dp_mode == "is":
            return gops.unit_normals(gen, leaves), None
        if b.dp_mode == "tm":
            return [tmsv.student_t3(gen, l.shape) for l in leaves], None
        return [torch.randn(l.shape, generator=gen, device=gen.device) for l in leaves], None

    def _d_step(self, state: TrainState, x, y, gen: torch.Generator, stds):
        b = self.builder
        bs = x.shape[0]
        z = b.gen_z(gen, bs)
        noise = fused = None
        if self.use_dp:
            noise, fused = self._noise(gen, [state.d_params[n] for n in b.d_leaves], stds)
        pen_x, pen_y, alphas = self._penalty_inputs(gen, x, y, bs)
        return b.d_core(state, x, y, z, self.use_dp, noise=noise, fused=fused, pen_x=pen_x,
                        pen_y=pen_y, alphas=alphas)

    def _g_step(self, state: TrainState, gen: torch.Generator, bs: int):
        b = self.builder
        z, y = b.gen_z(gen, bs), b.gen_y(gen, bs)
        if b.family == "vanilla":
            return b.g_step(state, z, None if y is None else one_hot(y, b.n_classes))
        return b.g_step_dcresnet(state, z, y)

    def run(self, state: TrainState, gen_perm: torch.Generator,
            gen: torch.Generator, k: int):
        """k epochs from `state`. Returns (state, D metric sums, G metric
        sums, number of G updates)."""
        b = self.builder
        bs = b.opt.batch_size
        dev = gen.device
        d_sums: Dict[str, torch.Tensor] = {}
        g_sums: Dict[str, torch.Tensor] = {}
        g_count = 0
        if self.d_acc is None:
            self.d_acc = torch.zeros((), device=dev)
        timed = dev.type == "cuda"
        self.epoch_events = []
        stds = None
        if self.use_dp and b.dp_mode == "gc":
            stds = gops.noise_stds(len(b.d_leaves), b.sigma, state.clipping, b.per_layer)
            if b.fused_route:    # K6 reads each leaf's std from device memory
                stds = torch.tensor(stds, dtype=torch.float32, device=dev)
        for j in range(k):
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            perm = torch.randperm(self.n_rows, generator=gen_perm, device=dev)
            for i in range(self.n):
                x, y = self._batch(perm[i * bs:(i + 1) * bs], gen)
                state, dm = self._d_step(state, x, y, gen, stds)
                for key, v in dm.items():
                    d_sums[key] = d_sums[key] + v if key in d_sums else v
                if "is_sens" in dm:
                    sens = dm["is_sens"]
                    if "is_sens_min" not in d_sums:
                        d_sums["is_sens_min"] = torch.full_like(sens, math.inf)
                        d_sums["is_sens_max"] = torch.full_like(sens, -math.inf)
                    d_sums["is_sens_min"] = torch.minimum(d_sums["is_sens_min"], sens)
                    d_sums["is_sens_max"] = torch.maximum(d_sums["is_sens_max"], sens)
                self.d_acc = self.d_acc + dm["d_adv_loss"]
                if i % self.n_d == 0:
                    g_on = (self.threshold >= 1e10
                            or float(self.d_acc) / self.n_d < self.threshold)
                    if g_on:
                        state, gm = self._g_step(state, gen, bs)
                        for key, v in gm.items():
                            g_sums[key] = g_sums[key] + v if key in g_sums else v
                        g_count += 1
                    self.d_acc = torch.zeros((), device=dev)
                if self.on_sample is not None and (i + 1) * bs % self.sample_every == 0:
                    self.on_sample(state, j, i)
            if timed:
                ev[1].record()
                self.epoch_events.append(ev)
        return state, d_sums, g_sums, g_count
