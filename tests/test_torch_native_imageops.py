"""The port's native image decoder (csl_gan_tpu_torch/data/native, built
by g++ into build/) and CelebA's decode-once cache, on JPEGs that PIL
writes into a temporary directory:

  - the resample against PIL's BILINEAR (within 1 LSB, the bound of
    tests/test_native_imageops.py for the JAX package's copy);
  - the decode against the PIL decode path (``_decode``), within 1 LSB,
    and bytes equal to the JAX package's ``native.decode_batch``;
  - missing and truncated files flagged as failed;
  - the cache: the file name is the JAX package's, the second call
    memory-maps it, and the bytes equal the JAX ``decoded_cache``'s; the
    PIL path (no native library) gives the same images within 1 LSB and
    says which decoder ran;
  - without the system's libjpeg, the build against ``jpeg62/`` and
    Pillow's libjpeg decodes the same bytes.
"""

import os

import numpy as np
import pytest

from csl_gan_tpu.data import celeba as jceleba
from csl_gan_tpu.data import native as jnative
from csl_gan_tpu_torch.data import celeba, native

PIL = pytest.importorskip("PIL")
from PIL import Image  # noqa: E402

pytestmark = pytest.mark.skipif(not native.available(),
                                reason=f"g++/libjpeg unavailable: {native.why_unavailable}")


def _write_jpegs(root, n, size=(178, 218), seed=3):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n):
        a = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        p = os.path.join(root, str(i + 1).zfill(6) + ".jpg")
        Image.fromarray(a).save(p, quality=95)
        paths.append(p)
    return paths


def test_library_builds_into_the_build_directory():
    so = native.target()
    assert so.exists() and so.parent.name == "build"
    assert so.parent.parent == native.SRC.parents[3]
    assert not any(p.suffix == ".so" for p in native.SRC.parent.iterdir())


@pytest.mark.parametrize("tw,th", [(64, 78), (52, 64), (178, 218), (300, 340), (37, 91)])
def test_resample_matches_pil_bilinear(tw, th):
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (218, 178, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(base).resize((tw, th), Image.BILINEAR)).astype(int)
    got = native.resample(base, tw, th).astype(int)
    assert np.abs(ref - got).max() <= 1


def test_decode_matches_pil_and_the_jax_decoder(tmp_path):
    root = str(tmp_path / "celeba")
    paths = _write_jpegs(root, 5)
    ds = celeba.CelebADataset(root, im_size=64, length=5)
    assert not ds.synthetic
    out, ok = native.decode_batch(paths, 64, n_threads=2)
    assert ok.all()
    for i in range(5):
        ref = np.clip(ds._decode(i + 1) * 255.0 + 0.5, 0, 255).astype(int)
        assert np.abs(ref - out[i].astype(int)).max() <= 1
    if jnative.available():
        jout, jok = jnative.decode_batch(paths, 64, n_threads=2)
        assert jok.all()
        np.testing.assert_array_equal(out, jout)


def test_decode_flags_failures(tmp_path):
    paths = _write_jpegs(str(tmp_path / "c2"), 2)
    bad, trunc = str(tmp_path / "missing.jpg"), str(tmp_path / "trunc.jpg")
    with open(paths[0], "rb") as f:
        blob = f.read()
    with open(trunc, "wb") as f:
        f.write(blob[:40])
    _, ok = native.decode_batch([paths[0], bad, paths[1], trunc], 64)
    assert list(ok) == [True, False, True, False]


def test_cache_is_the_jax_packages_and_memory_mapped(tmp_path, capsys):
    root = str(tmp_path / "c3")
    _write_jpegs(root, 7, size=(90, 110))
    ds = celeba.CelebADataset(root, im_size=48, length=7)
    jds = jceleba.CelebADataset(root, im_size=48, length=7)
    cache = str(tmp_path / "cache")
    assert ds.cache_path() == os.path.join(root, "_decoded_cache", "celeba_48_0_7.npy")
    arr, labels = ds.decoded_cache(cache_dir=cache, n_threads=2)
    assert "decoder native (2 threads), 0 image(s) by PIL" in capsys.readouterr().out
    assert ds.decode_stats["decoder"] == "native (2 threads)"
    path = os.path.join(cache, "celeba_48_0_7.npy")
    assert isinstance(arr, np.memmap) and os.path.exists(path)
    assert arr.shape == (7, 48, 48, 3) and arr.dtype == np.uint8
    again, _ = ds.decoded_cache(cache_dir=cache)
    assert isinstance(again, np.memmap) and ds.decode_stats["decoder"] == "cache"
    np.testing.assert_array_equal(again, arr)
    want, jlabels = jds.decoded_cache(cache_dir=str(tmp_path / "jcache"))
    np.testing.assert_array_equal(arr, want)
    np.testing.assert_array_equal(labels, jlabels)
    for i in range(7):
        ref = np.clip(ds._decode(i + 1) * 255.0 + 0.5, 0, 255).astype(int)
        assert np.abs(ref - arr[i].astype(int)).max() <= 1


def test_cache_falls_back_to_pil_and_says_so(tmp_path, monkeypatch, capsys):
    """Without the library every image goes to PIL; a file the decoder
    flags goes to PIL alone."""
    root = str(tmp_path / "c4")
    _write_jpegs(root, 4, size=(70, 120))
    monkeypatch.setattr(native, "available", lambda: False)
    ds = celeba.CelebADataset(root, im_size=32, length=4)
    pil, _ = ds.decoded_cache(cache_dir=str(tmp_path / "pil"))
    assert "decoder PIL, 4 image(s) by PIL" in capsys.readouterr().out
    monkeypatch.undo()
    real = native.decode_batch

    def one_fails(paths, im_size, n_threads=0):
        out, ok = real(paths, im_size, n_threads)
        ok[1] = False
        out[1] = 0
        return out, ok

    monkeypatch.setattr(native, "decode_batch", one_fails)
    mixed, _ = celeba.CelebADataset(root, im_size=32, length=4).decoded_cache(
        cache_dir=str(tmp_path / "mixed"))
    assert "1 image(s) by PIL" in capsys.readouterr().out
    np.testing.assert_array_equal(mixed[1], pil[1])
    assert np.abs(mixed.astype(int) - pil.astype(int)).max() <= 1


def test_pillow_libjpeg_build_decodes_the_same_bytes(tmp_path, monkeypatch):
    """Without the system's libjpeg the library compiles against jpeg62/
    and links Pillow's libjpeg; it decodes the same bytes."""
    if native._pillow_libjpeg() is None:
        pytest.skip("this Pillow ships no libjpeg of its own")
    paths = _write_jpegs(str(tmp_path / "c5"), 3)
    want, _ = native.decode_batch(paths, 64, n_threads=2)
    monkeypatch.setattr(native, "LIBS", ["-ljpeg_that_is_not_there"])
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "link", "")
    assert native.available() and native.link.endswith(native._pillow_libjpeg().name)
    got, ok = native.decode_batch(paths, 64, n_threads=2)
    assert ok.all()
    np.testing.assert_array_equal(got, want)


def test_a_cache_file_cut_short_is_decoded_again(tmp_path):
    """The JAX package writes its cache in place: a file another process is
    still writing does not load whole, and the port decodes anew."""
    root = str(tmp_path / "c6")
    _write_jpegs(root, 3, size=(90, 110))
    ds = celeba.CelebADataset(root, im_size=32, length=3)
    cache = str(tmp_path / "cache")
    want = np.array(ds.decoded_cache(cache_dir=cache)[0])    # off the mapped file
    path = ds.cache_path(cache)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    again, _ = celeba.CelebADataset(root, im_size=32, length=3).decoded_cache(cache_dir=cache)
    np.testing.assert_array_equal(again, want)
