"""The Inception path of the port's tools/fid.py against the JAX package's,
on the CPU, with the seeded random weights of tests/test_inception_parity.py
(the canonical pt_inception weights are not in the repository)."""

import os

import numpy as np
import pytest
import torch
from test_inception_parity import scaled_random_params

from csl_gan_tpu.tools import fid as jfid
from csl_gan_tpu.tools import inception as jinc
from csl_gan_tpu_torch.tools import fid
from csl_gan_tpu_torch.utils.images import save_image

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return scaled_random_params()


def test_inception_features_run_on_the_card_unless_the_cpu_is_asked(params, tmp_path,
                                                                    monkeypatch):
    """No quiet fallback: without a CUDA device, the default device raises."""
    path = str(tmp_path / "w.npz")
    np.savez(path, **params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("FID_INCEPTION_WEIGHTS", path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid.make_feature_fn("inception")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fid.make_feature_fn("auto")
    assert fid.make_feature_fn("pixel")[1] == "pixel_fid"


def test_fid_given_paths_matches_jax(params, tmp_path, monkeypatch):
    """``calculate_fid_given_paths(kind="inception")`` on two PNG directories.
    FID = Tr S1 + Tr S2 - 2 Tr sqrt(S1 S2) + |mu1 - mu2|^2. Tolerance: |gap|
    <= 1e-4 (Tr S1 + Tr S2 + |mu1 - mu2|^2), the sum of its non-negative
    terms: features that agree to ~3e-7 relative move each term by ~1e-6 of
    itself (the gap reads ~2e-6 of the FID here), the two packages' scipy
    sqrtm calls agree far below that, and a wrong feature (a quirk left out)
    moves the FID by far more than 1e-4."""
    path = str(tmp_path / "w.npz")
    np.savez(path, **params)
    monkeypatch.setenv("FID_INCEPTION_WEIGHTS", path)
    rng = np.random.default_rng(14)
    for d, scale in (("a", 1.0), ("b", 0.6)):
        os.makedirs(tmp_path / d)
        for i in range(10):
            save_image(scale * rng.random((24, 24, 3)).astype(np.float32),
                       str(tmp_path / d / f"{i}.png"))
    paths = (str(tmp_path / "a"), str(tmp_path / "b"))
    got, label = fid.calculate_fid_given_paths(paths, 5, kind="inception", device="cpu")
    want, jlabel = jfid.calculate_fid_given_paths(paths, 5, kind="inception")
    assert label == jlabel == "fid"
    feats = [np.asarray(jinc.make_inception_features(path)(jfid.load_images_from_dir(p)))
             for p in paths]
    mu_gap = feats[0].mean(axis=0) - feats[1].mean(axis=0)
    scale = sum(np.trace(np.cov(f, rowvar=False)) for f in feats) + mu_gap @ mu_gap
    assert want > 0 and abs(got - want) <= 1e-4 * scale, (got, want, scale)
