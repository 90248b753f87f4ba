"""In-memory datasets, a host batch sampler and data initialisation.

The training paths keep the whole dataset on the device (training/loop.py);
the host needs the dataset object, the per-epoch batch count, and single
shuffled batches for the mean sampler (``Loader.one_batch``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class ArrayDataset:
    """In-memory dataset of (images NHWC, labels int64). `transform`, when
    set, maps a raw image batch to the training representation on the host
    (uint8 CelebA -> [-1, 1] with a random horizontal flip)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, transform=None):
        self.images = images
        self.labels = labels
        self.transform = transform
        self.label_true_count = None

    def __len__(self):
        return len(self.images)


class Loader:
    """Shuffled fixed-size batches of an ArrayDataset (the JAX package's
    data/loader.py Loader, ``one_batch`` only)."""

    def __init__(self, dataset: ArrayDataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def one_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        idx = np.arange(len(self.dataset))
        self._rng.shuffle(idx)
        idx = idx[: self.batch_size]
        x = self.dataset.images[idx]
        if self.dataset.transform is not None:
            x = self.dataset.transform(x)
        return x, self.dataset.labels[idx]


def n_batches(dataset, batch_size: int) -> int:
    """Full batches per epoch (the trailing partial batch is dropped, like
    the reference's drop_last loaders)."""
    return len(dataset) // batch_size


def init_data(opt) -> ArrayDataset:
    """The training set: MNIST stratified to train_set_size (reference
    init_util.py:13-42), or CelebA decoded once to uint8 with its host
    transform (the JAX Trainer's decode-once path, training/loop.py:87-110)."""
    if opt.dataset == "CelebA":
        from csl_gan_tpu_torch.data import celeba

        ds = celeba.CelebADataset(opt.data_path, im_size=opt.im_size,
                                  length=opt.train_set_size,
                                  attr_file=opt.label_path, attr=opt.label_attr)
        u8, labels = ds.decoded_cache()
        flip_rng = np.random.default_rng(opt.manual_seed + 13)

        def host_transform(batch):
            x = np.asarray(batch, np.float32) / 127.5 - 1.0
            fl = flip_rng.random(len(x)) < 0.5
            x[fl] = x[fl, :, ::-1, :]
            return x

        out = ArrayDataset(u8, labels, transform=host_transform)
        out.label_true_count = ds.label_true_count
        return out
    from csl_gan_tpu_torch.data import mnist

    images, labels = mnist.load_mnist(opt.data_path, train=True)
    images, labels = mnist.stratified_subset(images, labels, opt.train_set_size)
    return ArrayDataset(images, labels)
