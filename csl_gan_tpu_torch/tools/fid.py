"""Frechet distance between two image sets (the port's copy of the JAX
package's tools/fid.py).

The pytorch_fid protocol of the reference (mem_inf_attack.py:416: batches of
50, the Frechet distance of feature statistics) with a choice of features:

  - "inception": InceptionV3 pool3 features (tools/inception.py) with the
    weights of the npz that ``$FID_INCEPTION_WEIGHTS`` names, labelled
    ``fid``; on the card unless the CPU is asked for. Without the file it
    raises ``FileNotFoundError``.
  - "pixel": flattened 16x16 area-downsampled grey pixels. Numbers are NOT
    comparable to Inception-FID and are labelled ``pixel_fid``.
  - "auto" (the default): Inception when the weights file exists, else
    pixel features, and it says so.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Tuple

import numpy as np
from scipy import linalg

from csl_gan_tpu_torch.utils.images import read_png


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """d^2 = |mu1-mu2|^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def activation_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def pixel_features(images: np.ndarray, res: int = 16) -> np.ndarray:
    """Grey images area-downsampled to res x res; images NHWC in [0, 1]."""
    x = np.asarray(images, dtype=np.float32)
    if x.shape[-1] == 3:
        x = x @ np.array([0.299, 0.587, 0.114], dtype=np.float32)
    else:
        x = x[..., 0]
    n, h, w = x.shape
    fh, fw = h // res, w // res
    if fh >= 1 and fw >= 1:
        x = x[:, : fh * res, : fw * res]
        x = x.reshape(n, res, fh, res, fw).mean(axis=(2, 4))
    return x.reshape(n, -1)


def inception_weights_path() -> Optional[str]:
    p = os.environ.get("FID_INCEPTION_WEIGHTS")
    return p if p and os.path.exists(p) else None


def make_feature_fn(kind: str = "auto", device=None) -> Tuple[Callable, str]:
    """(feature_fn(images) -> [N, D], label); Inception features on
    `device` (the card unless "cpu")."""
    if kind not in ("auto", "pixel", "inception"):
        raise ValueError(f"unknown FID feature kind {kind!r}")
    if kind in ("auto", "inception"):
        wpath = inception_weights_path()
        if wpath is not None:
            from csl_gan_tpu_torch.tools.inception import make_inception_features
            return make_inception_features(wpath, device), "fid"
        if kind == "inception":
            raise FileNotFoundError(
                "Inception FID weights not found; set FID_INCEPTION_WEIGHTS")
        print("FID: pixel features (16x16 grey); FID_INCEPTION_WEIGHTS names no file.")
    return pixel_features, "pixel_fid"


def features_from_images(images: np.ndarray, feature_fn: Callable,
                         batch_size: int = 50) -> np.ndarray:
    return np.concatenate([np.asarray(feature_fn(images[i:i + batch_size]))
                           for i in range(0, len(images), batch_size)])


def load_images_from_dir(path: str, limit: Optional[int] = None) -> np.ndarray:
    """The PNGs of a directory in name order as NHWC float32 in [0, 1]."""
    files = sorted(f for f in os.listdir(path) if f.lower().endswith(".png"))
    if limit:
        files = files[:limit]
    imgs = []
    for f in files:
        arr = read_png(os.path.join(path, f)).astype(np.float32) / 255.0
        imgs.append(arr[..., None] if arr.ndim == 2 else arr)
    return np.stack(imgs)


def calculate_fid(images1: np.ndarray, images2: np.ndarray, batch_size: int = 50,
                  kind: str = "auto", device=None) -> Tuple[float, str]:
    """(distance, label)."""
    feature_fn, label = make_feature_fn(kind, device)
    mu1, s1 = activation_statistics(features_from_images(images1, feature_fn, batch_size))
    mu2, s2 = activation_statistics(features_from_images(images2, feature_fn, batch_size))
    return frechet_distance(mu1, s1, mu2, s2), label


def calculate_fid_given_paths(paths, batch_size: int = 50, kind: str = "auto",
                              device=None) -> Tuple[float, str]:
    """The pytorch_fid entry point's shape (mem_inf_attack.py:416)."""
    return calculate_fid(load_images_from_dir(paths[0]), load_images_from_dir(paths[1]),
                         batch_size, kind, device)
