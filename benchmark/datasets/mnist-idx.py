"""MNIST-shaped training files in the IDX format: 28 x 28 uint8 images and
their labels, balanced over the classes, made once from the configuration's
``data_seed`` (a fixed data set, as a user trains on one) and kept under the
checkout's build directory.

Each class has a template of a few Gaussian strokes; a sample is its
template shifted by up to two pixels, scaled, with pixel noise, and with
faint pixels set to 0, so that most pixels are 0 as in MNIST.

``files(spec, root)`` returns {"data_path", "images", "labels"}: the
directory to pass to the program's ``--data_path`` and the two files that
the reference reads.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _images(n: int, n_classes: int, rng) -> tuple:
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    templates = np.zeros((n_classes, 28, 28), np.float32)
    for c in range(n_classes):
        for _ in range(4):
            cy, cx = rng.uniform(7, 21, 2)
            sy, sx = rng.uniform(1.5, 5.0, 2)
            templates[c] += np.exp(-((yy - cy) ** 2 / (2 * sy ** 2) + (xx - cx) ** 2
                                     / (2 * sx ** 2)))
    templates /= templates.max(axis=(1, 2), keepdims=True)
    labels = rng.permutation(np.arange(n) % n_classes)
    shifts = rng.integers(-2, 3, (n, 2))
    out = np.empty((n, 28, 28), np.uint8)
    for s in range(-2, 3):
        for t in range(-2, 3):
            rows = np.nonzero((shifts[:, 0] == s) & (shifts[:, 1] == t))[0]
            base = np.roll(templates, (s, t), axis=(1, 2))[labels[rows]]
            gain = rng.uniform(0.7, 1.0, (len(rows), 1, 1)).astype(np.float32)
            img = 255.0 * base * gain + rng.normal(0, 18, base.shape).astype(np.float32)
            img[img < 40] = 0
            out[rows] = np.clip(img, 0, 255).astype(np.uint8)
    return out, labels.astype(np.uint8)


def _write_idx(path: Path, arr: np.ndarray) -> None:
    head = bytes([0, 0, 8, arr.ndim]) + b"".join(int(d).to_bytes(4, "big") for d in arr.shape)
    tmp = path.with_name(path.name + f".part{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(head)
        f.write(np.ascontiguousarray(arr).tobytes())
    os.replace(tmp, path)


def files(spec: dict, root: Path) -> dict:
    raw = root / "MNIST" / "raw"
    images, labels = raw / "train-images-idx3-ubyte", raw / "train-labels-idx1-ubyte"
    if not (images.exists() and labels.exists()):
        raw.mkdir(parents=True, exist_ok=True)
        x, y = _images(spec["rows"], spec["n_classes"], np.random.default_rng(spec["data_seed"]))
        _write_idx(labels, y)
        _write_idx(images, x)
    return {"data_path": str(root) + "/", "images": str(images), "labels": str(labels)}
