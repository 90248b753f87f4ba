"""In-memory dataset and data initialisation for the ported MNIST path.

The training path keeps the whole dataset on the device as one flat table
(training/loop.py); only the dataset object and the per-epoch batch count are
needed on the host.
"""

from __future__ import annotations

import numpy as np


class ArrayDataset:
    """In-memory dataset of (images NHWC float32, labels int64)."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.images)


def n_batches(dataset, batch_size: int) -> int:
    """Full batches per epoch (the trailing partial batch is dropped, like
    the reference's drop_last loaders)."""
    return len(dataset) // batch_size


def init_data(opt) -> ArrayDataset:
    """The MNIST training set, stratified to train_set_size
    (reference init_util.py:13-42)."""
    from csl_gan_tpu_torch.data import mnist

    images, labels = mnist.load_mnist(opt.data_path, train=True)
    images, labels = mnist.stratified_subset(images, labels, opt.train_set_size)
    return ArrayDataset(images, labels)
