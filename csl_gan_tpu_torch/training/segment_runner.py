"""The runners that drive whole epochs, or segments of one: ``EpochsRunner``
(the MNIST vanilla path, one K1 launch per epoch or segment) and
``StepRunner`` (every other ported configuration of either model, one D step
at a time with a G update on the n_d_steps cadence, and the non-private
warmup of every configuration), and ``PublicRows``, the public split on the
device. A segment is the run of batches [start, cut) of an epoch between two
sub-epoch log or sample cuts (the JAX Trainer's ``_epoch_scan``); an epoch
without one is a single segment.

EpochsRunner:

For each epoch it draws, on the device and from the Trainer's generators, the
permutation of the table rows (``epoch_perm``); for each segment every step's
randomness (z_d, z_g, y_g and the DP noise), in the order K1 consumes them
(the JAX package pre-draws the same way at ops/pallas_epoch.py:492-514), then
calls ``epoch_kernel`` once over the segment's steps: K1 takes its step count
from its inputs, so a segment needs no other kernel. Metric sums stay on the
device; the caller reads them once per group or segment.

The streams are torch's, so they differ from the JAX package's for the same
seed; value parity is tested with injected draws (tests/test_torch_epoch.py).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional

import numpy as np
import torch

from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.models.mnist import D_LEAVES
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.ops import pallas_epoch, tmsv
from csl_gan_tpu_torch.privacy.mean_sampler import MeanSampler
from csl_gan_tpu_torch.training import penalty as penalty_mod
from csl_gan_tpu_torch.training.steps import StepBuilder, TrainState


class EpochsRunner:
    def __init__(self, builder: StepBuilder, n_batches: int, use_dp: bool):
        self.builder = builder
        self.n = n_batches
        self.use_dp = use_dp
        # On CUDA: (start, end) events around each epoch (draws + kernel) of
        # the last run() call, for per-epoch device times.
        self.epoch_events: List[tuple] = []

    def epoch_perm(self, table: torch.Tensor, gen_perm: torch.Generator) -> torch.Tensor:
        return torch.randperm(table.shape[0], generator=gen_perm, device=table.device)

    def draw(self, table: torch.Tensor, perm: torch.Tensor, gen: torch.Generator,
             state: TrainState, start: int, cut: int):
        """Inputs of the segment's steps [start, cut): gathered rows, z_d,
        z_g, one_hot(y_g), noise."""
        b = self.builder
        bs, n = b.opt.batch_size, cut - start
        rows = table[perm[start * bs:cut * bs]]
        z_d = b.gen_z(gen, bs, (n,))
        z_g = b.gen_z(gen, bs, (n,))
        ohg = one_hot(b.gen_y(gen, bs, (n,)), b.n_classes)
        noise: Optional[List[torch.Tensor]] = None
        if self.use_dp:
            noise = gops.noise_like(gen, [state.d_params[k] for k in D_LEAVES],
                                    gops.noise_std(b.sigma, state.clipping),
                                    lead=(n,))
        return rows, z_d, z_g, ohg, noise

    def run_segment(self, state: TrainState, table: torch.Tensor, perm: torch.Tensor,
                    gen: torch.Generator, start: int, cut: int):
        """Steps [start, cut) of the epoch whose row permutation is ``perm``,
        in one K1 launch. Returns (state, metric sums [40] on device)."""
        params, mu, nu = pallas_epoch.leaves_of(state)
        t = (state.d_count, state.g_count)
        rows, z_d, z_g, ohg, noise = self.draw(table, perm, gen, state, start, cut)
        params, mu, nu, met = pallas_epoch.epoch_kernel(
            self.builder, rows, z_d, z_g, ohg, noise, state.clipping, t,
            params, mu, nu, use_dp=self.use_dp)
        t = (t[0] + cut - start, t[1] + cut - start)
        return pallas_epoch.state_from_leaves(params, mu, nu, state.clipping, t), met

    def run(self, state: TrainState, table: torch.Tensor,
            gen_perm: torch.Generator, gen: torch.Generator, k: int):
        """k epochs from `state`. Returns (state, metric sums [40] on device)."""
        met = torch.zeros(pallas_epoch.MET_SLOTS, dtype=torch.float32,
                          device=table.device)
        timed = table.is_cuda
        self.epoch_events = []
        for _ in range(k):
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            perm = self.epoch_perm(table, gen_perm)
            state, m = self.run_segment(state, table, perm, gen, 0, self.n)
            met += m
            if timed:
                ev[1].record()
                self.epoch_events.append(ev)
        return state, met


class PublicRows:
    """The public split on the device (the JAX Trainer's ``_dev_public``,
    training/loop.py:404-414): images (uint8 CelebA rows, normalised to
    [-1, 1] and randomly flipped after each gather as the training rows are,
    or fp32 MNIST rows) and labels, and per class the rows of that class as
    an index table [n_classes, largest class] (padded with the class's first
    row) with the class counts, from which class-matched rows are drawn on
    the device."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor, n_classes: int):
        self.images = images
        self.labels = labels
        self.n = images.shape[0]
        self.u8 = images.dtype == torch.uint8
        lab = labels.cpu()
        rows = [torch.nonzero(lab == c).flatten() for c in range(max(1, n_classes))]
        self.counts = torch.tensor([len(r) for r in rows], device=labels.device)
        width = max(len(r) for r in rows)
        self.by_class = torch.stack(
            [torch.cat([r, r[:1].expand(width - len(r))]) if len(r) else
             torch.zeros(width, dtype=torch.int64) for r in rows]).to(labels.device)
        self.empty = [c for c, r in enumerate(rows) if not len(r)]

    def gather(self, idx: torch.Tensor, gen: torch.Generator):
        """(images [B, H, W, C] fp32, labels) of the rows idx; uint8 rows
        draw their horizontal flips from gen."""
        x = self.images[idx]
        if self.u8:
            flip = torch.rand(x.shape[0], generator=gen, device=x.device) < 0.5
            x = x.float() / 127.5 - 1.0
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        return x, self.labels[idx]

    def batch(self, gen: torch.Generator, size: int):
        """The first ``size`` rows of a fresh permutation (JAX
        ``_adaptive_data`` and the public loader's ``one_batch``)."""
        perm = torch.randperm(self.n, generator=gen, device=self.images.device)
        return self.gather(perm[:size], gen)

    def class_matched(self, gen: torch.Generator, y: torch.Tensor):
        """For each label of y a row of that class, uniformly at random (JAX
        ``_penalty_data``, which draws them on the host)."""
        if self.empty:
            raise ValueError(f"the public split holds no row of class {self.empty[0]}, "
                             "which a class-matched penalty batch needs")
        u = torch.rand(y.shape[0], generator=gen, device=y.device)
        cnt = self.counts[y]
        j = torch.minimum((u * cnt).long(), cnt - 1)
        return self.gather(self.by_class[y, j], gen)


class StepRunner:
    """k whole epochs, or a segment of one, one D step at a time (the JAX
    package's segment_runner.py _build_run, written as a Python loop over
    steps): the D step of the config's ``dp_mode`` (training/steps.py
    ``d_core``: gc by the route the config selects, is, tm / sv, or without
    DP the model's plain D step); the G step of the model family.

    Per epoch it draws the row permutation from ``gen_perm`` (none for DP
    runs under ``--poisson``, none from the device under ``--host_loop``,
    whose host loader shuffles); per step, from ``gen`` and in this order:
    under DP with ``--poisson`` the step's
    Poisson inclusion (``StepBuilder.poisson_draw``: a [cap] batch with a
    validity mask, in place of the permutation's slice; JAX
    segment_runner.py:204-210), the horizontal flips (uint8 image tables),
    z_d, the DP noise (gc: per-leaf normals times the stds, or on the fused
    route the per-leaf seeds and then the small leaves' normals,
    ``ops/grads.draw_fused_noise``; is: one N(0, 1) draw sliced per leaf,
    which the step scales by its own stds on the device; tm: Student-t(3)
    per leaf; sv: N(0, 1) per leaf), the penalty batch (the mean-sample
    surrogates, or the real batch without mean samples or under ``-pupd
    false``) and each penalty's draw, one row per sample (WGAN-GP's
    interpolation weights, DRAGAN's U(0, 1) noise shaped like the batch;
    under the gc per-sample penalty the same draws serve its samples and
    its logged batch value); on a G update, z_g and y_g. An epoch keeps its
    ``n_batches`` steps under ``--poisson``; G updates take ``--batch_size``
    rows. The G update follows the D steps i with i % n_d_steps == 0, gated while
    train_d_until_threshold < 1e10 by the mean D adversarial loss since the
    last cadence point (one host read per cadence point; none without
    gating). Metric sums stay on the device; the caller reads them once per
    group. Under ``-dpm is`` the sums also hold the run's least and largest
    ``is_sens`` (``is_sens_min`` / ``is_sens_max``, from +inf / -inf, kept
    on the device).

    Under a data axis (``StepBuilder.mesh``) every rank makes every draw
    above, the same global values, and each step keeps its rows: the draws
    and the generators stay in step across ranks, and an N-rank run trains
    what the one-device run trains. The noise is drawn from shape-only
    stand-ins of D's leaves (``StepBuilder.d_templates``), whole under
    --fsdp too. The threshold gate takes rank 0's decision (its ``d_acc``
    is every rank's: the metrics are of the gathered outputs).

    Under ``--group_fakes`` (``StepBuilder.grouped_runner_ok``), a segment
    that starts on a cadence point runs by cadence groups (JAX
    ``_build_grouped_run``, segment_runner.py:336): the D steps up to and
    including the next cadence point share one G, so their batches come
    from one row gather, their draws are made in the per-batch order, their
    fakes come from one (m * bs)-row G forward (``StepBuilder.batch_fakes``,
    K4 at that batch on the card) of the same z, and each D step takes its
    slice; then the G update. The draws, the steps and the G updates are
    those of the per-batch path; only the batched forward's reduction order
    differs. Other segments take the per-batch loop.

    Under adaptive clipping each gc D step also draws its clipping batch,
    after the penalty's draws: ``bs`` public rows (``PublicRows.batch``), or
    ``bs`` mean samples with uniform labels (``MeanSampler.device_sample``).
    With a public split the penalty batch is class-matched public rows
    (``PublicRows.class_matched``; unconditional runs: the first ``bs`` of a
    permutation), else the mean-sample surrogates, else the real batch.
    Each gc step's thresholds are summed into ``d_sums["clipping"]`` on the
    device.

    ``warmup`` runs ``-wi`` non-private D steps on public rows or mean
    samples (the JAX Trainer's ``warmup``), each followed by a G step on the
    same cadence and gate as training, and counts none of them for privacy.

    ``gather(idx) -> (x, y)`` returns a batch's images and labels from the
    device-resident dataset; with ``u8_images`` the images are uint8 and get
    the JAX Trainer's ``/127.5 - 1`` and random flip after the gather. With a
    host ``loader`` (``--host_loop`` on CelebA) each batch comes from it,
    decoded, flipped and normalised on the host, and is copied to the
    device. An unconditional run's steps take no labels (y None, the G
    step's too), and its penalty batch none either (JAX
    segment_runner.py:208-234).
    """

    def __init__(self, builder: StepBuilder, n_batches: int, n_rows: int,
                 gather: Optional[Callable], u8_images: bool,
                 mean_sampler: Optional[MeanSampler] = None,
                 mean_samples: Optional[torch.Tensor] = None,
                 public: Optional[PublicRows] = None, loader=None,
                 device: Optional[torch.device] = None):
        self.builder = builder
        self.n = n_batches
        self.n_rows = n_rows
        self.gather = gather
        self.u8_images = u8_images
        self.mean_sampler = mean_sampler
        self.mean_samples = mean_samples
        self.public = public
        self.loader = loader
        self.device = device
        opt = builder.opt
        self.use_dp = bool(opt.use_dp)
        self.adaptive = builder.adaptive and builder.dp_mode == "gc" and self.use_dp
        self.n_d = max(1, int(opt.n_d_steps))
        self.threshold = float(opt.train_d_until_threshold)
        self.grouped = builder.grouped_runner_ok(self.use_dp) and loader is None
        # Running D adversarial-loss sum since the last cadence point; it
        # persists across run() calls, like the JAX runner's carry.
        self.d_acc = None
        self.epoch_events: List[tuple] = []

    def _prep(self, x, y, gen: torch.Generator):
        if not self.builder.conditional:
            y = None
        if self.u8_images:
            flip = torch.rand(x.shape[0], generator=gen, device=x.device) < 0.5
            x = x.float() / 127.5 - 1.0
            x = torch.where(flip[:, None, None, None], x.flip(2), x)
        return x, y

    def _batch(self, idx: torch.Tensor, gen: torch.Generator):
        return self._prep(*self.gather(idx), gen)

    def _surrogate_batch(self, gen: torch.Generator, bs: int):
        """``bs`` public rows, else ``bs`` mean samples with uniform labels:
        the adaptive clipping and warmup batches (labels None when
        unconditional)."""
        if self.public is not None:
            x, y = self.public.batch(gen, bs)
        else:
            x, y = self.mean_sampler.device_sample(self.mean_samples, gen, None, bs)
        return x, (y if self.builder.conditional else None)

    def _penalty_inputs(self, gen: torch.Generator, x: torch.Tensor,
                        y: Optional[torch.Tensor], bs: int):
        """The penalty's batch (under ``-pupd false`` the real batch, else
        class-matched public rows, else the mean-sample surrogates, else the
        real batch, as the JAX Trainer's ``_penalty_data`` picks it) and each
        penalty's draw (``penalty.draw_shape``)."""
        b = self.builder
        if not b.penalty_types:
            return None, None, None
        pen_x, pen_y = x, y
        surrogate = b.opt.penalty_use_public_data
        if surrogate and self.public is not None:
            pen_x, pen_y = (self.public.batch(gen, bs)[0], None) if y is None else \
                self.public.class_matched(gen, y)
        elif surrogate and self.mean_sampler is not None:
            pen_x, pen_y = self.mean_sampler.device_sample(self.mean_samples, gen, y, bs)
            if not b.conditional:
                pen_y = None
        draws = [torch.rand(penalty_mod.draw_shape(t, pen_x.shape), generator=gen,
                            device=x.device) for t in b.penalty_types]
        return pen_x, pen_y, draws

    def _noise(self, gen: torch.Generator, leaves, stds):
        """(noise, fused) of one DP step, as the mode's D step takes them;
        under adaptive clipping (stds None) unit normals, which the step
        scales by its own stds."""
        b = self.builder
        if b.dp_mode == "gc":
            if b.fused_route:
                return None, gops.draw_fused_noise(gen, leaves, stds)
            if stds is None:
                return gops.unit_normals(gen, leaves), None
            return gops.noise_like(gen, leaves, stds), None
        if b.dp_mode == "is":
            return gops.unit_normals(gen, leaves), None
        if b.dp_mode == "tm":
            return [tmsv.student_t3(gen, l.shape) for l in leaves], None
        return [torch.randn(l.shape, generator=gen, device=gen.device) for l in leaves], None

    def _d_draws(self, state: TrainState, x, y, gen: torch.Generator, stds, use_dp: bool):
        """Every draw of one D step after its batch, in the stream's order
        (z, noise, penalty batch and draws, adaptive batch); none depends on
        the state's values, so the grouped runner can make a group's draws
        before its steps."""
        b = self.builder
        bs = x.shape[0]
        z = b.gen_z(gen, bs)
        noise = fused = None
        if use_dp:
            noise, fused = self._noise(gen, b.d_templates, stds)
        pen_x, pen_y, alphas = self._penalty_inputs(gen, x, y, bs)
        ax = ay = None
        if use_dp and self.adaptive:
            ax, ay = self._surrogate_batch(gen, b.opt.batch_size)
        return dict(z=z, noise=noise, fused=fused, pen_x=pen_x, pen_y=pen_y, alphas=alphas,
                    ax=ax, ay=ay)

    def _g_step(self, state: TrainState, gen: torch.Generator):
        b = self.builder
        bs = b.opt.batch_size
        return b.g_core(state, b.gen_z(gen, bs), b.gen_y(gen, bs))

    def _train_batch(self, state: TrainState, x, y, gen: torch.Generator, stds, i: int,
                     use_dp: bool, sums, valid=None, draws=None, fake=None):
        """D step i of an epoch (or of the warmup) and, on the cadence, the
        gated G step; metrics summed into ``sums`` = [d_sums, g_sums, g_count].
        ``draws`` (the step's own, from ``_d_draws``) are made here unless
        given; ``fake`` replaces the D step's G forward. Returns the state."""
        d_sums, g_sums = sums[0], sums[1]
        if draws is None:
            draws = self._d_draws(state, x, y, gen, stds, use_dp)
        z = draws.pop("z")
        state, dm = self.builder.d_core(state, x, y, z, use_dp, valid=valid, fake=fake,
                                        **draws)
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
            # Under a data axis every rank takes rank 0's decision: a G step
            # launches collectives, so no rank may branch alone.
            g_on = (self.threshold >= 1e10
                    or self.builder.mesh.agree(float(self.d_acc) / self.n_d < self.threshold))
            if g_on:
                state, gm = self._g_step(state, gen)
                for key, v in gm.items():
                    g_sums[key] = g_sums[key] + v if key in g_sums else v
                sums[2] += 1
            self.d_acc = torch.zeros((), device=gen.device)
        return state

    def warmup(self, state: TrainState, gen: torch.Generator, n_iter: int):
        """``n_iter`` non-private D steps on surrogate batches (public rows,
        else mean samples with uniform labels), each followed by a G step on
        the n_d_steps cadence (JAX training/loop.py:903-915, without its
        optimizer reset, which the caller makes). Returns (state, D metric
        sums, G metric sums, number of G updates)."""
        if self.d_acc is None:
            self.d_acc = torch.zeros((), device=gen.device)
        sums = [{}, {}, 0]
        for i in range(n_iter):
            x, y = self._surrogate_batch(gen, self.builder.opt.batch_size)
            state = self._train_batch(state, x, y, gen, None, i, False, sums)
        return (state, *sums)

    def epoch_source(self, gen_perm: torch.Generator):
        """What an epoch's batches come from: the row permutation of the
        device dataset, None under DP with ``--poisson``, or the host
        loader's batches."""
        if self.loader is not None:
            return iter(self.loader)
        if self.use_dp and self.builder.poisson:
            return None
        return torch.randperm(self.n_rows, generator=gen_perm, device=gen_perm.device)

    def noise_stds(self, state: TrainState):
        """The gc noise's per-leaf stds for the run (None under adaptive
        clipping and outside gc); a device tensor on the fused route, from
        which K6 reads them."""
        b = self.builder
        if not (self.use_dp and b.dp_mode == "gc" and not self.adaptive):
            return None
        stds = gops.noise_stds(len(b.d_leaves), b.sigma, state.clipping, b.per_layer)
        if b.fused_route:
            return torch.tensor(stds, dtype=torch.float32, device=self.device)
        return stds

    def run_segment(self, state: TrainState, src, gen: torch.Generator, start: int,
                    cut: int, sums, stds=None):
        """D steps [start, cut) of an epoch from ``src`` (``epoch_source``),
        each with its G update on the cadence, metrics summed into ``sums``;
        cadence groups when the runner is grouped and ``start`` is a cadence
        point. Returns the state."""
        if self.d_acc is None:
            self.d_acc = torch.zeros((), device=gen.device)
        if self.grouped and src is not None and start % self.n_d == 0:
            return self._grouped_segment(state, src, gen, start, cut, sums, stds)
        b = self.builder
        bs = b.opt.batch_size
        for i in range(start, cut):
            valid = None
            if self.loader is not None:
                hx, hy = next(src)
                x, y = self._prep(torch.from_numpy(np.ascontiguousarray(hx)).to(self.device),
                                  torch.from_numpy(np.asarray(hy, np.int64)).to(self.device),
                                  gen)
            elif src is None:
                idx, valid = b.poisson_draw(gen, self.n_rows)
                x, y = self._batch(idx, gen)
            else:
                x, y = self._batch(src[i * bs:(i + 1) * bs], gen)
            state = self._train_batch(state, x, y, gen, stds, i, self.use_dp, sums, valid)
        return state

    def _grouped_segment(self, state: TrainState, perm: torch.Tensor, gen: torch.Generator,
                         start: int, cut: int, sums, stds):
        b = self.builder
        bs = b.opt.batch_size
        i = start
        while i < cut:
            j = i               # the group: steps i..j, j the next cadence point
            while j < cut - 1 and j % self.n_d != 0:
                j += 1
            m = j - i + 1
            xs, ys = self.gather(perm[i * bs:(j + 1) * bs])
            steps = []
            for s in range(m):
                x, y = self._prep(xs[s * bs:(s + 1) * bs], ys[s * bs:(s + 1) * bs], gen)
                steps.append((x, y, self._d_draws(state, x, y, gen, stds, self.use_dp)))
            fakes = b.batch_fakes(state, torch.stack([d["z"] for _, _, d in steps]),
                                  None if steps[0][1] is None
                                  else torch.stack([y for _, y, _ in steps]))
            for s, (x, y, draws) in enumerate(steps):
                state = self._train_batch(state, x, y, gen, stds, i + s, self.use_dp, sums,
                                          draws=draws, fake=fakes[s])
            i = j + 1
        return state

    def run(self, state: TrainState, gen_perm: torch.Generator,
            gen: torch.Generator, k: int):
        """k epochs from `state`. Returns (state, D metric sums, G metric
        sums, number of G updates)."""
        sums = [{}, {}, 0]
        timed = gen.device.type == "cuda"
        self.epoch_events = []
        stds = self.noise_stds(state)
        for _ in range(k):
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            state = self.run_segment(state, self.epoch_source(gen_perm), gen, 0, self.n,
                                     sums, stds)
            if timed:
                ev[1].record()
                self.epoch_events.append(ev)
        return (state, *sums)
