"""--download_mnist in the port against the JAX package, with no network:
both packages' mirrors are ``file://`` URLs of a directory under tmp_path
that holds the four IDX .gz files, made with numpy from a seed (40 train
rows, 20 test rows, labels cycling 0-9). The same mirror gives both
packages bitwise-equal arrays and byte-equal files in ``MNIST/raw``; a
missing first mirror falls through to the second; a file already there, .gz
or unpacked, is not fetched again; with no mirror answering both raise
RuntimeError naming --download_mnist; the port's init_data gives the JAX
init_data's arrays, and its Trainer trains one epoch on the fetched files."""

import csv
import gzip
import math
import os
import sys
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from csl_gan_tpu import options as joptions
from csl_gan_tpu.data import loader as jloader
from csl_gan_tpu.data import mnist as jmnist
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.data import loader as tloader
from csl_gan_tpu_torch.data import mnist as tmnist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import write_idx_gz, write_mnist_mirror  # noqa: E402

# The JAX package's options.parse creates ./output (see
# tests/test_torch_trainer_basics.py): made here, at collection, so that two
# xdist workers do not race on it.
os.makedirs("output", exist_ok=True)

NAMES = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte",
         "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte")
N_TRAIN, N_TEST = 40, 20


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def make_mirror(root, seed=0):
    """A mirror directory of the four files; returns (its file:// URL with
    a trailing slash, {name: uint8 array})."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for (img, lbl), n in zip((NAMES[:2], NAMES[2:]), (N_TRAIN, N_TEST)):
        arrays[img] = rng.integers(0, 256, size=(n, 28, 28), dtype=np.uint8)
        arrays[lbl] = (np.arange(n) % 10).astype(np.uint8)
    return write_mnist_mirror(root, arrays), arrays


@pytest.fixture
def mirror(tmp_path):
    return make_mirror(tmp_path / "mirror")


@pytest.fixture
def fetched(monkeypatch):
    """Every URL urlretrieve is asked for, by either package."""
    urls = []
    retrieve = urllib.request.urlretrieve

    def counting(url, *a, **kw):
        urls.append(url)
        return retrieve(url, *a, **kw)
    monkeypatch.setattr(urllib.request, "urlretrieve", counting)
    return urls


def set_mirrors(monkeypatch, mirrors):
    for mod in (jmnist, tmnist):
        monkeypatch.setattr(mod, "_MIRRORS", tuple(mirrors))


def missing(tmp_path):
    return (tmp_path / "no_such_mirror").as_uri() + "/"


def load_both(tmp_path, train, download=True):
    """(JAX arrays, port arrays), each package on a data path of its own."""
    return tuple(mod.load_mnist(str(tmp_path / tag), train=train, download=download)
                 for mod, tag in ((jmnist, "jax"), (tmnist, "port")))


@pytest.mark.parametrize("order", ["first", "fallback"])
def test_download_matches_jax(tmp_path, monkeypatch, mirror, fetched, order):
    """The same mirror, first or behind a missing one, gives both packages
    the mirror's bytes in ``<data_path>/MNIST/raw`` and bitwise-equal
    arrays, the pixels the file's bytes / 255; each package fetches each
    file once, from the mirror that answers, in the JAX package's order."""
    url, arrays = mirror
    mirrors = [url] if order == "first" else [missing(tmp_path), url]
    set_mirrors(monkeypatch, mirrors)
    for train, (img, lbl) in ((True, NAMES[:2]), (False, NAMES[2:])):
        (jx, jy), (tx, ty) = load_both(tmp_path, train)
        assert tx.dtype == jx.dtype == np.float32 and ty.dtype == jy.dtype == np.int64
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
        assert np.array_equal(tx[..., 0], arrays[img].astype(np.float32) / 255.0)
        assert np.array_equal(ty, arrays[lbl])
    mirror_dir = tmp_path / "mirror"
    for tag in ("jax", "port"):
        raw = tmp_path / tag / "MNIST" / "raw"
        assert sorted(os.listdir(raw)) == sorted(n + ".gz" for n in NAMES)
        for name in NAMES:
            assert (raw / (name + ".gz")).read_bytes() == (mirror_dir / (name + ".gz")).read_bytes()
    # Both loads of a package fetch all four files on the first (train) load.
    per_package = [m + n + ".gz" for n in NAMES for m in mirrors]
    assert fetched == per_package + per_package


@pytest.mark.parametrize("form", ["gz", "unpacked"])
def test_present_file_is_not_fetched(tmp_path, monkeypatch, mirror, fetched, form):
    """A file already in MNIST/raw, gzipped or unpacked, is kept and not
    fetched again; the other three are fetched. Both packages read the file
    that was there (other labels than the mirror's)."""
    url, arrays = mirror
    set_mirrors(monkeypatch, [url])
    ours = (np.arange(N_TRAIN)[::-1] % 10).astype(np.uint8)
    for tag in ("jax", "port"):
        raw = tmp_path / tag / "MNIST" / "raw"
        raw.mkdir(parents=True)
        write_idx_gz(raw / (NAMES[1] + ".gz"), ours)
        if form == "unpacked":
            with gzip.open(raw / (NAMES[1] + ".gz"), "rb") as fh:
                (raw / NAMES[1]).write_bytes(fh.read())
            (raw / (NAMES[1] + ".gz")).unlink()
    # The raw directory counts as found only once the train images are
    # there, so the load fetches.
    (jx, jy), (tx, ty) = load_both(tmp_path, True)
    assert np.array_equal(tx, jx) and np.array_equal(ty, jy) and np.array_equal(ty, ours)
    want = [url + n + ".gz" for n in NAMES if n != NAMES[1]]
    assert fetched == want + want
    for tag in ("jax", "port"):
        names = sorted(os.listdir(tmp_path / tag / "MNIST" / "raw"))
        kept = NAMES[1] + (".gz" if form == "gz" else "")
        assert names == sorted([n + ".gz" for n in NAMES if n != NAMES[1]] + [kept])


def test_no_mirror_raises(tmp_path, monkeypatch, fetched):
    """With every mirror missing both packages raise RuntimeError naming
    --download_mnist, every URL tried and the raw directory, and return no
    synthetic set; without the flag both give the synthetic set, as
    before."""
    mirrors = [missing(tmp_path), (tmp_path / "nor_this").as_uri() + "/"]
    set_mirrors(monkeypatch, mirrors)
    for mod, tag in ((jmnist, "jax"), (tmnist, "port")):
        with pytest.raises(RuntimeError, match="--download_mnist") as err:
            mod.load_mnist(str(tmp_path / tag), train=True, download=True)
        msg = str(err.value)
        assert all(m + NAMES[0] + ".gz" in msg for m in mirrors)
        assert str(tmp_path / tag / "MNIST" / "raw") in msg
        assert os.listdir(tmp_path / tag / "MNIST" / "raw") == []
    assert fetched == [m + NAMES[0] + ".gz" for m in mirrors] * 2
    (jx, jy), (tx, ty) = load_both(tmp_path / "plain", False, download=False)
    assert np.array_equal(tx, jx) and np.array_equal(ty, jy) and len(tx) == 10000


def test_second_load_needs_no_mirror(tmp_path, monkeypatch, mirror, fetched):
    """Once the files are there, a load with or without the flag reads them
    with every mirror unreachable, and fetches nothing."""
    url, arrays = mirror
    set_mirrors(monkeypatch, [url])
    first = load_both(tmp_path, True)
    set_mirrors(monkeypatch, [missing(tmp_path)])
    del fetched[:]
    for download in (True, False):
        again = load_both(tmp_path, True, download=download)
        for (x0, y0), (x1, y1) in zip(first, again):
            assert np.array_equal(x0, x1) and np.array_equal(y0, y1)
    assert fetched == []


def argv(tmp_path, tag, extra=()):
    return ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-tss", str(N_TRAIN),
            "-bs", "8", "--manual_seed", "3", "--download_mnist",
            "-d", str(tmp_path / tag / "data"), "-o", str(tmp_path / tag / "out"), *extra]


def test_init_data_matches_jax(tmp_path, monkeypatch, mirror):
    """The port's init_data and the JAX init_data under --download_mnist
    -pss 20: the same private rows (stratified) and public rows (the test
    split), bitwise."""
    url, arrays = mirror
    set_mirrors(monkeypatch, [missing(tmp_path), url])
    jds, _, jpub, _ = jloader.init_data(joptions.parse(argv(tmp_path, "jax", ["-pss", "20"])))
    tds, tpub = tloader.init_data(toptions.parse(argv(tmp_path, "port", ["-pss", "20",
                                                                         "--platform", "cpu"])))
    for a, b in ((jds, tds), (jpub, tpub)):
        assert np.array_equal(a.images, b.images) and np.array_equal(a.labels, b.labels)
    assert len(tds) == N_TRAIN and len(tpub) == N_TEST
    assert np.array_equal(tpub.images[..., 0], arrays[NAMES[2]].astype(np.float32) / 255.0)


def test_trainer_trains_on_downloaded_files(tmp_path, monkeypatch, mirror):
    """``options.parse`` takes --download_mnist, and a CPU Trainer fetches
    the files and trains one epoch on them (K1's plain version): the
    dataset is the mirror's bytes / 255 and the logged losses are finite."""
    from csl_gan_tpu_torch.training.loop import Trainer

    url, arrays = mirror
    set_mirrors(monkeypatch, [url])
    opt = toptions.parse(argv(tmp_path, "port", ["-ne", "1", "--log_every", str(N_TRAIN),
                                                 "--platform", "cpu"]))
    assert opt.download_mnist and toptions._k1_path(opt)
    tr = Trainer(opt)
    want_x, want_y = tmnist.stratified_subset(
        arrays[NAMES[0]].astype(np.float32)[..., None] / 255.0,
        arrays[NAMES[1]].astype(np.int64), N_TRAIN)
    assert np.array_equal(tr.dataset.images, want_x) and np.array_equal(tr.dataset.labels, want_y)
    tr.run()
    assert sorted(os.listdir(tmp_path / "port" / "data" / "MNIST" / "raw")) == \
        sorted(n + ".gz" for n in NAMES)
    with open(tmp_path / "port" / "out" / "log.csv") as fh:
        rows = list(csv.DictReader(fh))
    assert rows and all(math.isfinite(float(rows[-1][k])) for k in
                        ("G Adv Loss", "D Adv Loss", "D Real Loss", "D Fake Loss"))
    assert tr.state.d_count == N_TRAIN // 8


@pytest.mark.parametrize("cut", ["missing", "interrupt", "killed"])
def test_cut_fetch_leaves_no_partial_file(tmp_path, monkeypatch, mirror, cut):
    """A fetch that stops part way places no file in the port's MNIST/raw:
    the files fetched so far wait under temporary names and are removed
    ("missing": the third file is on no mirror; "interrupt": Ctrl-C while
    the second file is half written). A temporary file that a killed fetch
    left ("killed") is read by no load. Afterwards a load without the flag
    still finds no MNIST, and a load with it fetches the mirror's files."""
    url, arrays = mirror
    data = tmp_path / "port"
    raw = data / "MNIST" / "raw"
    if cut == "missing":
        (tmp_path / "mirror" / (NAMES[2] + ".gz")).unlink()
        set_mirrors(monkeypatch, [url])
        with pytest.raises(RuntimeError, match="--download_mnist"):
            tmnist.load_mnist(str(data), train=True, download=True)
        write_idx_gz(tmp_path / "mirror" / (NAMES[2] + ".gz"), arrays[NAMES[2]])
    elif cut == "interrupt":
        set_mirrors(monkeypatch, [url])
        retrieve, calls = urllib.request.urlretrieve, []

        def interrupted(src, dst):
            calls.append(src)
            if len(calls) == 2:
                Path(dst).write_bytes(Path(url[len("file://"):] + NAMES[1] + ".gz")
                                      .read_bytes()[:20])
                raise KeyboardInterrupt
            return retrieve(src, dst)
        monkeypatch.setattr(urllib.request, "urlretrieve", interrupted)
        with pytest.raises(KeyboardInterrupt):
            tmnist.load_mnist(str(data), train=True, download=True)
        monkeypatch.setattr(urllib.request, "urlretrieve", retrieve)
    else:
        raw.mkdir(parents=True)
        (raw / (NAMES[0] + ".gz.x1y2.part")).write_bytes(b"\x1f\x8b\x08")
    if cut != "killed":
        assert os.listdir(raw) == []
    x, _ = tmnist.load_mnist(str(data), train=False)
    assert len(x) == 10000                       # the synthetic set: nothing found
    set_mirrors(monkeypatch, [url])
    x, y = tmnist.load_mnist(str(data), train=True, download=True)
    assert np.array_equal(x[..., 0], arrays[NAMES[0]].astype(np.float32) / 255.0)
    assert np.array_equal(y, arrays[NAMES[1]])
    assert sorted(n for n in os.listdir(raw) if not n.endswith(".part")) == \
        sorted(n + ".gz" for n in NAMES)
