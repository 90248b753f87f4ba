"""In-memory datasets, a host batch loader and data initialisation.

The training paths keep the whole dataset, and the public split, on the
device (training/loop.py), but for CelebA under ``--host_loop``, whose
batches the ``Loader`` decodes on the host one at a time. The host also
needs the dataset objects, the per-epoch batch count, and single shuffled
batches for the mean sampler (``Loader.one_batch``).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

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

    def __getitem__(self, i):
        x = self.images[i]
        if self.transform is not None:
            x = self.transform(x[None])[0]
        return x, self.labels[i]

    def get_item_with_label(self, label, _rng=np.random):
        """A random row of class ``label`` (JAX data/loader.py:47-49)."""
        idx = np.nonzero(self.labels == label)[0]
        return self[int(idx[_rng.randint(len(idx))])]


class Loader:
    """Shuffled fixed-size batches of a dataset (the JAX package's
    data/loader.py Loader): an ArrayDataset's rows by one fancy index, any
    other dataset (CelebA under ``--host_loop``) item by item. An epoch
    drops its last partial batch; batches of a dataset that decodes are
    assembled by a background thread, PREFETCH ahead."""
    PREFETCH = 2

    def __init__(self, dataset, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._rng = np.random.default_rng(seed)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        self._rng.shuffle(idx)
        return idx

    def _make_batch(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if isinstance(self.dataset, ArrayDataset):
            x = self.dataset.images[idx]
            if self.dataset.transform is not None:
                x = self.dataset.transform(x)
            return x, self.dataset.labels[idx]
        xs, ys = zip(*(self.dataset[int(i)] for i in idx))
        return np.stack(xs), np.asarray(ys, dtype=np.int64)

    def one_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        return self._make_batch(self._epoch_indices()[: self.batch_size])

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        idx = self._epoch_indices()
        bs = self.batch_size
        batches = [idx[i * bs:(i + 1) * bs] for i in range(len(idx) // bs)]
        if isinstance(self.dataset, ArrayDataset):
            for b in batches:
                yield self._make_batch(b)
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        done = object()

        def produce():
            try:
                for b in batches:
                    q.put(self._make_batch(b))
            finally:
                q.put(done)

        threading.Thread(target=produce, daemon=True).start()
        while (item := q.get()) is not done:
            yield item


def n_batches(dataset, batch_size: int) -> int:
    """Full batches per epoch (the trailing partial batch is dropped, like
    the reference's drop_last loaders)."""
    return len(dataset) // batch_size


def init_data(opt) -> Tuple[object, Optional[ArrayDataset]]:
    """(training set, public split or None), as the JAX package's init_data
    (data/loader.py:140-174) splits them. The training set: MNIST stratified
    to train_set_size (reference init_util.py:13-42; both splits fetched
    first under ``--download_mnist`` when no files are found), or CelebA read from its
    decode-once uint8 cache (``-nw`` decoder threads) with its host
    transform (the JAX Trainer's decode-once path, training/loop.py:87-110);
    under ``--host_loop`` the CelebA dataset itself, which decodes each image
    when a batch asks for it. The public split, with ``-pss`` > 0: MNIST's
    whole test split whatever the value of ``-pss``; CelebA's
    ``public_set_size`` rows after the training rows, from their own cache
    (normalised and flipped on the device after each gather)."""
    if opt.dataset == "CelebA":
        from csl_gan_tpu_torch.data import celeba

        def dataset(length, offset, seed):
            return celeba.CelebADataset(opt.data_path, im_size=opt.im_size, length=length,
                                        offset=offset, attr_file=opt.label_path,
                                        attr=opt.label_attr, rng_seed=seed)

        def decoded(length, offset, flip_seed):
            ds = dataset(length, offset, 0)
            u8, labels = ds.decoded_cache(n_threads=int(opt.num_workers or 0))
            flip_rng = np.random.default_rng(flip_seed)

            def host_transform(batch):
                x = np.asarray(batch, np.float32) / 127.5 - 1.0
                fl = flip_rng.random(len(x)) < 0.5
                x[fl] = x[fl, :, ::-1, :]
                return x

            out = ArrayDataset(u8, labels, transform=host_transform)
            out.label_true_count = ds.label_true_count
            return out

        public = (decoded(opt.public_set_size, opt.train_set_size, opt.manual_seed + 14)
                  if opt.public_set_size > 0 else None)
        if opt.host_loop:
            return dataset(opt.train_set_size, 0, opt.manual_seed), public
        return decoded(opt.train_set_size, 0, opt.manual_seed + 13), public
    from csl_gan_tpu_torch.data import mnist

    download = bool(getattr(opt, "download_mnist", False))
    images, labels = mnist.load_mnist(opt.data_path, train=True, download=download)
    images, labels = mnist.stratified_subset(images, labels, opt.train_set_size)
    public = None
    if opt.public_set_size > 0:
        public = ArrayDataset(*mnist.load_mnist(opt.data_path, train=False,
                                                download=download))
    return ArrayDataset(images, labels), public
