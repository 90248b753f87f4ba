"""MNIST loading: IDX parser with a deterministic synthetic fallback.

The port's own copy of the JAX package's MNIST loader. Reads the standard IDX
files from ``<data_path>/MNIST/raw/`` (torchvision's layout, also probed at
``<data_path>`` directly; .gz accepted). When no files exist it generates the
same deterministic synthetic digit-like dataset, so both packages train on
identical pixels, unless ``download`` is set: then the four IDX ``.gz`` files
are fetched into ``<data_path>/MNIST/raw`` from the first mirror that answers
(``download_mnist``), and a failed fetch raises instead of falling back.
Images are float32 in [0, 1], NHWC (B, 28, 28, 1).
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Tuple

import numpy as np

_RAW_NAMES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _read_idx(path: str) -> np.ndarray:
    with _open_maybe_gz(path) as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_raw_dir(data_path: str):
    for cand in [os.path.join(data_path, "MNIST", "raw"), data_path]:
        img_name = _RAW_NAMES[True][0]
        if os.path.exists(os.path.join(cand, img_name)) or \
                os.path.exists(os.path.join(cand, img_name + ".gz")):
            return cand
    return None


def synthetic_mnist(n: int = 60000, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic digit-like synthetic data (class-dependent blob patterns).

    Each class c gets a fixed low-frequency template; samples are the template
    plus bounded pixel noise, clipped to [0,1]. Classes are balanced.
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32) / 27.0
    templates = []
    for c in range(10):
        fx, fy = 1 + c % 4, 1 + c // 4
        t = 0.5 + 0.5 * np.sin(np.pi * fx * xx + c) * np.cos(np.pi * fy * yy - c / 3.0)
        templates.append(t.astype(np.float32))
    templates = np.stack(templates)
    labels = np.arange(n) % 10
    rng.shuffle(labels)
    imgs = templates[labels] + rng.normal(0, 0.15, size=(n, 28, 28)).astype(np.float32)
    imgs = np.clip(imgs, 0.0, 1.0)[..., None]
    return imgs, labels.astype(np.int64)


# The public MNIST mirrors, in the order they are tried (torchvision's list;
# the reference downloads through torchvision under --download_mnist).
_MIRRORS = (
    "https://ossci-datasets.s3.amazonaws.com/mnist/",
    "http://yann.lecun.com/exdb/mnist/",
)


def download_mnist(data_path: str) -> str:
    """Fetch the four IDX .gz files into ``<data_path>/MNIST/raw`` (the
    torchvision layout), train images, train labels, test images, test
    labels, skipping a file already there (.gz or unpacked) and trying each
    of ``_MIRRORS`` in turn. Raises RuntimeError listing every URL tried
    when a file cannot be fetched: an explicit --download_mnist never falls
    back to the synthetic set. Returns the raw directory.

    Each file is fetched under a temporary name of its own beside it and
    moved into place only once every file is fetched, the train images (by
    which a load finds the directory) last: a cut fetch leaves no partial
    file under a name that a load reads, and a load running beside the
    fetch finds either no directory or all four files."""
    import tempfile
    import urllib.error
    import urllib.request

    raw = os.path.join(data_path or ".", "MNIST", "raw")
    os.makedirs(raw, exist_ok=True)
    errors, parts = [], []
    try:
        for name in [n + ".gz" for pair in _RAW_NAMES.values() for n in pair]:
            dst = os.path.join(raw, name)
            if os.path.exists(dst) or os.path.exists(dst[:-3]):
                continue
            fd, part = tempfile.mkstemp(prefix=name + ".", suffix=".part", dir=raw)
            os.close(fd)
            parts.append((part, dst))
            for mirror in _MIRRORS:
                try:
                    urllib.request.urlretrieve(mirror + name, part)
                    break
                except (urllib.error.URLError, OSError, ValueError) as e:
                    errors.append(f"{mirror + name}: {e}")
            else:
                raise RuntimeError(
                    "--download_mnist: could not fetch MNIST (no network access?); tried:\n  "
                    + "\n  ".join(errors) + f"\nPlace the IDX files under {raw} manually, "
                    "or drop --download_mnist to use the synthetic fallback.")
        while parts:
            # In reverse: the train images, fetched first, land last.
            os.replace(*parts[-1])
            parts.pop()
    finally:
        for part, _ in parts:
            if os.path.exists(part):
                os.remove(part)
    return raw


def fetch_mnist(data_path: str) -> str:
    """The raw directory under ``data_path``, fetched first
    (``download_mnist``) when none is found."""
    raw = _find_raw_dir(data_path) if data_path else None
    if raw is None:
        download_mnist(data_path or ".")
        raw = _find_raw_dir(data_path or ".")
    return raw


def load_mnist(data_path: str, train: bool = True,
               download: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(images [N,28,28,1] float32 0..1, labels [N] int64). With
    ``download``, the files are fetched when no raw directory is found."""
    if download:
        raw = fetch_mnist(data_path)
    else:
        raw = _find_raw_dir(data_path) if data_path else None
    if raw is None:
        print(f"[csl_gan_tpu_torch] MNIST not found under {data_path!r}; "
              "using deterministic synthetic MNIST.")
        return synthetic_mnist(60000 if train else 10000, seed=0 if train else 1)
    img_name, lbl_name = _RAW_NAMES[train]
    images = _read_idx(os.path.join(raw, img_name)).astype(np.float32) / 255.0
    labels = _read_idx(os.path.join(raw, lbl_name)).astype(np.int64)
    return images[..., None], labels


def stratified_subset(images: np.ndarray, labels: np.ndarray,
                      train_set_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """First train_set_size//10 samples of each class, in dataset order
    (reference init_util.py:19-23)."""
    per_class = train_set_size // 10
    keep = np.concatenate([np.nonzero(labels == c)[0][:per_class]
                           for c in range(10)])
    return images[keep], labels[keep]
