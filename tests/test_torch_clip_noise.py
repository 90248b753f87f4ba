"""The plain version of K6 (csl_gan_tpu_torch/ops/pallas_clip.py) on the CPU.

The JAX package's Pallas body draws from the TPU's own generator
(``pltpu.prng_*``) and cannot run off its accelerator (its own
tests/test_pallas.py skips there), so the JAX side here is its plain
reference, ``ops/grads._weighted_sum`` / ``jnp.einsum``: both sides take the
same fp32 sum in another order, held to rtol 1e-5. The noise stream is the
port's own (Philox4x32-10 keyed by the seed, the element index as the
counter); it is held against an independent numpy-uint64 transcription, the
Random123 known answers, a numpy transcription of the TPU kernel's
Box-Muller (csl_gan_tpu/ops/pallas_clip.py:50-58), and the moment bounds of
the JAX package's tests/test_pallas.py:35-48.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu_torch.ops import pallas_clip as pc


@pytest.mark.parametrize("shape", [(16, 100, 333), (8, 16384)])
def test_plain_sum_matches_jax_weighted_sum(shape):
    rng = np.random.default_rng(0)
    g = rng.standard_normal(shape).astype(np.float32)
    w = rng.uniform(0.1, 1.0, shape[0]).astype(np.float32)
    want = jgops._weighted_sum({"k": jnp.asarray(g)}, jnp.asarray(w)[None])["k"]
    got = pc.leaf_weighted_sum_noise(torch.tensor(g), torch.tensor(w), 7, 0.0)
    assert tuple(got.shape) == shape[1:]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    ein = jnp.einsum("b,bp->p", jnp.asarray(w), jnp.asarray(g).reshape(shape[0], -1))
    np.testing.assert_allclose(got.numpy().ravel(), np.asarray(ein), rtol=1e-5, atol=1e-5)


def _philox_np(ctr, key):
    """Philox4x32-10 in numpy uint64 arithmetic (Random123's philox.h)."""
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    mask, sh = np.uint64(0xFFFFFFFF), np.uint64(32)
    c = [np.asarray(x, np.uint64) for x in ctr]
    k = [np.asarray(x, np.uint64) for x in key]
    for _ in range(10):
        p0, p1 = m0 * c[0], m1 * c[2]       # < 2^64: no wrap
        c = [(p1 >> sh) ^ c[1] ^ k[0], p1 & mask, (p0 >> sh) ^ c[3] ^ k[1], p0 & mask]
        k = [(k[0] + np.uint64(0x9E3779B9)) & mask, (k[1] + np.uint64(0xBB67AE85)) & mask]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's kat_vectors for philox4x32-10."""
    t = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    got = pc.philox4x32_10(tuple(t(c) for c in ctr), tuple(t(k) for k in key))
    assert tuple(int(x) for x in got) == want
    assert tuple(int(x) for x in _philox_np(ctr, key)) == want


def test_philox_matches_numpy_on_random_words():
    rng = np.random.default_rng(1)
    ctr = rng.integers(0, 2 ** 32, (4, 4096), dtype=np.uint64)
    key = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64)
    got = pc.philox4x32_10(tuple(torch.tensor(c.astype(np.int64)) for c in ctr),
                           tuple(torch.tensor(k.astype(np.int64)) for k in key))
    for g, w in zip(got, _philox_np(ctr, key)):
        np.testing.assert_array_equal(g.numpy().astype(np.uint64), w)


def test_normal_from_bits_matches_the_tpu_transform():
    """Bit patterns 0 and 0xFFFFFFFF included: finite, no NaN."""
    rng = np.random.default_rng(2)
    b1 = np.concatenate([[0, 0xFFFFFFFF, 0, 0xFFFFFFFF],
                         rng.integers(0, 2 ** 32, 5000)]).astype(np.int64)
    b2 = np.concatenate([[0, 0xFFFFFFFF, 0xFFFFFFFF, 0],
                         rng.integers(0, 2 ** 32, 5000)]).astype(np.int64)
    u1 = (b1 >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24)) + np.float32(0.5 / (1 << 24))
    u2 = (b2 >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24))
    want = np.sqrt(np.float32(-2.0) * np.log(u1)) * np.cos(np.float32(2.0 * np.pi) * u2)
    got = pc.normal_from_bits(torch.tensor(b1), torch.tensor(b2)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert abs(got[0] - np.sqrt(2 * 25 * np.log(2.0))) < 1e-4   # u1 = 2^-25, u2 = 0


def test_plain_stream_moments_seeds_and_determinism():
    p, std = 1 << 17, 2.5
    g = torch.zeros(4, p)
    w = torch.ones(4)
    a = pc.leaf_weighted_sum_noise(g, w, 42, std)
    assert torch.equal(a, pc.leaf_weighted_sum_noise(g, w, torch.tensor(42), torch.tensor(std)))
    b = pc.leaf_weighted_sum_noise(g, w, 43, std)
    assert float((a - b).abs().max()) > 0.1
    assert abs(float(a.mean())) < 0.05
    assert abs(float(a.std()) - std) / std < 0.02
    # Independent across seeds and along the counter.
    z, z2 = (a / std).numpy(), (b / std).numpy()
    assert abs(np.corrcoef(z, z2)[0, 1]) < 0.01
    assert abs(np.corrcoef(z[:-1], z[1:])[0, 1]) < 0.01
    # The stream does not depend on how many elements are drawn, and a seed's
    # high word reaches the key.
    np.testing.assert_allclose(pc.philox_normal(torch.tensor(42), 1000).numpy(), z[:1000],
                               atol=1e-6)
    hi = pc.philox_normal(torch.tensor(42 + (1 << 32)), 1000)
    assert float((hi - pc.philox_normal(torch.tensor(42), 1000)).abs().max()) > 0.1


def test_wrapper_rejects_other_devices():
    g = torch.zeros(2, 4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        pc.leaf_weighted_sum_noise(g, torch.ones(2, device="meta"), 0, 0.0)
