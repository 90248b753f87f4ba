"""Privatized per-class mean samples as public surrogate data (the port's
copy of the JAX package's privacy/mean_sampler.py).

``num_samples`` noisy per-class mean images are built once from the training
set; each D step then picks surrogates from them with fresh small noise for
the gradient penalty, and ``get_privacy_cost`` gives the RDP cost of their
release, which the Trainer adds to epsilon. Unlike the JAX package, the mean
images are not written out as PNGs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from csl_gan_tpu_torch.privacy import rdp as rdp_mod


class MeanSampler:
    """mean_size and num_samples are per class (reference mean_sampler.py:16)."""

    def __init__(self, dataloader=None, noise_std: float = 0.1,
                 num_samples: int = 32, mean_size: int = 100,
                 dataset_size: int = 180000, res: int = 64, ch: int = 3,
                 n_classes: int = 1, smallest_class_size: Optional[float] = None,
                 seed: int = 0):
        self.noise_std = noise_std
        self.num_samples = num_samples
        self.mean_size = mean_size
        self.dataset_size = dataset_size
        self.res = res
        self.ch = ch
        self.n_classes = n_classes
        self.sample_rate = (mean_size / dataset_size if smallest_class_size is None
                            else mean_size / smallest_class_size)
        self._rng = np.random.default_rng(seed)
        if dataloader is not None:
            self.make_mean_samples(dataloader)

    def make_mean_samples(self, dataloader) -> None:
        """One noisy class mean per (class, sample index):
        [n_classes, num_samples, H, W, C] (reference mean_sampler.py:48-73)."""
        per_class = [[] for _ in range(self.n_classes)]
        for _ in range(self.num_samples):
            samples, labels = dataloader.one_batch()
            for c in range(self.n_classes):
                if self.n_classes > 1:
                    s = samples[labels == c]
                    s = s[: self.mean_size].sum(axis=0) / self.mean_size
                else:
                    s = samples.sum(axis=0) / self.mean_size
                noise = self._rng.normal(0, self.noise_std, size=s.shape)
                per_class[c].append((s + noise).astype(np.float32))
        self.mean_samples = np.stack([np.stack(s) for s in per_class])
        self.res = self.mean_samples.shape[-3]
        self.ch = self.mean_samples.shape[-1]

    def get_privacy_cost(self, target_delta: float = 1e-6,
                         alphas=None) -> Tuple[float, float]:
        """RDP cost of releasing all mean samples (mean_sampler.py:86-92):
        each is a mean of `mean_size` samples with per-pixel sensitivity
        1/(2*mean_size) and Gaussian noise noise_std."""
        alphas = rdp_mod.DEFAULT_ALPHAS if alphas is None else alphas
        pixel_sensitivity = 1 / self.mean_size / 2
        l2_sensitivity = float(np.sqrt(self.ch * self.res ** 2 * pixel_sensitivity ** 2))
        r = rdp_mod.compute_rdp(self.sample_rate, self.noise_std / l2_sensitivity,
                                self.num_samples * self.n_classes, orders=alphas)
        return rdp_mod.get_privacy_spent(orders=alphas, rdp=r, delta=target_delta)

    @staticmethod
    def pick(samples: torch.Tensor, labels: torch.Tensor, idx: torch.Tensor,
             n_mean: torch.Tensor, n_pix: torch.Tensor) -> torch.Tensor:
        """samples[labels, idx] + 0.01 * n_mean [size, 1, 1, 1] + 0.01 *
        n_pix [size, H, W, C]: the JAX device sampler's arithmetic on given
        draws (mean_sampler.py:128-136)."""
        r = samples[labels, idx]
        r = r + 0.01 * n_mean
        return r + 0.01 * n_pix

    def device_sample(self, samples: torch.Tensor, gen: torch.Generator,
                      labels: Optional[torch.Tensor], size: int):
        """The counterpart of device_sample_fn (mean_sampler.py:117-138) on
        device-resident mean samples [n_classes, num_samples, H, W, C]:
        labels drawn uniformly when None, sample indices with replacement.
        Returns (images, labels)."""
        dev = samples.device
        if labels is None:
            labels = torch.randint(0, self.n_classes, (size,), generator=gen, device=dev)
        idx = torch.randint(0, self.num_samples, (size,), generator=gen, device=dev)
        n_mean = torch.randn((size, 1, 1, 1), generator=gen, device=dev)
        n_pix = torch.randn((size,) + tuple(samples.shape[2:]), generator=gen, device=dev)
        return self.pick(samples, labels, idx, n_mean, n_pix), labels
