"""The epochs runner: k whole epochs through the epoch kernel K1.

For each epoch it draws, on the device and from the Trainer's generators, the
permutation of the table rows and every step's randomness (z_d, z_g, y_g and
the DP noise), in the order K1 consumes them (the JAX package pre-draws the
same way at ops/pallas_epoch.py:492-514), then calls ``epoch_kernel`` once.
Metric sums stay on the device; the caller reads them once per group.

The streams are torch's, so they differ from the JAX package's for the same
seed; value parity is tested with injected draws (tests/test_torch_epoch.py).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from csl_gan_tpu_torch.models.common import one_hot
from csl_gan_tpu_torch.models.mnist import D_LEAVES
from csl_gan_tpu_torch.ops import grads as gops
from csl_gan_tpu_torch.ops import pallas_epoch
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
