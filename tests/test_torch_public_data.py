"""The public split (``-pss``) of the port against the JAX package's, on the
CPU:

  - ``init_data``'s public split equals JAX ``init_data``'s bit for bit: the
    MNIST test split (synthetic here, seed 1) whatever ``-pss`` is, and the
    CelebA rows after the training rows (synthetic images decoded to uint8
    as the JAX package's ``decoded_cache`` rounds them, and their labels);
    the Trainer holds them on the device;
  - class-matched penalty rows (``PublicRows.class_matched``) carry the
    requested labels and are rows of that class; the surrogate batches of
    unconditional runs carry no labels;
  - the two option rules this slice adds raise the JAX package's messages on
    the same argv;
  - ``options._k1_path`` equals ``ops/pallas_epoch.supports`` on the
    Trainer's builder, and picks the Trainer's runner, for a batch of 50,
    adaptive runs and the flagship.
"""

import os

import numpy as np
import pytest
import torch

from csl_gan_tpu import options as joptions
from csl_gan_tpu.data.loader import init_data as jax_init_data
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.data import init_data
from csl_gan_tpu_torch.ops import pallas_epoch
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner, StepRunner

os.makedirs("output", exist_ok=True)

MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-bs", "32", "-tss", "160",
         "--manual_seed", "3"]
CELEBA = ["CelebA", "--conditional", "-dpm", "gc", "-bs", "8", "-tss", "16", "--im_size", "48",
          "--bf16", "true", "--train_d_until_threshold", "1e18", "--manual_seed", "3"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("pss", ["20", "5000"])
def test_mnist_public_split_is_the_jax_one(tmp_path, pss):
    args = MNIST + ["-pss", pss]
    _, _, jpub, jloader = jax_init_data(joptions.parse(args + ["-o", str(tmp_path / "j")]))
    opt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "t")])
    train, pub = init_data(opt)
    assert len(train) == 160 and len(pub) == len(jpub) == 10000
    np.testing.assert_array_equal(pub.images, jpub.images)
    np.testing.assert_array_equal(pub.labels, jpub.labels)
    assert pub.images.dtype == np.float32 and jloader.batch_size == opt.batch_size
    # A random row of a class, as the JAX dataset's get_item_with_label.
    for label in (0, 7):
        x, got = pub.get_item_with_label(label)
        assert got == label and x.shape == (28, 28, 1)
        assert any(np.array_equal(x, r) for r in jpub.images[jpub.labels == label])
    _, no_pub = init_data(toptions.parse(MNIST + ["--platform", "cpu", "-o", str(tmp_path)]))
    assert no_pub is None


def test_celeba_public_split_is_the_jax_one(tmp_path):
    args = CELEBA + ["-pss", "12"]
    _, _, jpub, _ = jax_init_data(joptions.parse(args + ["-o", str(tmp_path / "j")]))
    want, want_labels = jpub.decoded_cache(cache_dir=str(tmp_path / "cache"))
    assert jpub.offset == 16 and len(jpub) == 12
    opt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "t")])
    train, pub = init_data(opt)
    assert pub.images.dtype == np.uint8 and pub.images.shape == (12, 48, 48, 3)
    np.testing.assert_array_equal(pub.images, want)
    np.testing.assert_array_equal(pub.labels, want_labels)
    assert pub.label_true_count == jpub.label_true_count
    # The public rows are not training rows.
    assert not any(np.array_equal(pub.images[0], t) for t in train.images)
    tr = Trainer(opt)
    assert tr.public.u8 and tr.public.images.dtype == torch.uint8
    np.testing.assert_array_equal(tr.public.images.numpy(), want)
    np.testing.assert_array_equal(tr.public.labels.numpy(), want_labels)
    x, y = tr.public.batch(torch.Generator().manual_seed(1), 5)
    assert x.dtype == torch.float32 and x.shape == (5, 48, 48, 3)
    assert float(x.min()) >= -1.0 and float(x.max()) <= 1.0


def test_class_matched_rows_carry_the_requested_labels(tmp_path):
    opt = toptions.parse(MNIST + ["-pss", "10", "--platform", "cpu", "-o", str(tmp_path)])
    tr = Trainer(opt)
    pub = tr.public
    assert not pub.u8 and pub.counts.tolist() == np.bincount(pub.labels.numpy()).tolist()
    gen = torch.Generator().manual_seed(4)
    y = torch.tensor([3, 3, 0, 9, 1, 7, 7, 7, 2, 5] * 4)
    x, got = pub.class_matched(gen, y)
    assert torch.equal(got, y) and x.shape == (40, 28, 28, 1)
    flat = pub.images.reshape(pub.n, -1)
    for xi, yi in zip(x.reshape(40, -1), y):
        rows = torch.nonzero((flat == xi).all(dim=1)).flatten()
        assert len(rows) >= 1 and bool((pub.labels[rows] == yi).all())
    # Not one fixed row a class: 40 draws from classes of 1000 rows.
    assert len({tuple(r.tolist()) for r in x.reshape(40, -1)}) >= 35
    # The surrogate batches: uniform public rows, no labels when unconditional.
    xs, ys = tr.step_runner._surrogate_batch(gen, 32)
    assert xs.shape == (32, 28, 28, 1) and ys.shape == (32,)
    unc = Trainer(toptions.parse([a for a in MNIST if a != "--conditional"]
                                 + ["-pss", "10", "--platform", "cpu", "-o", str(tmp_path / "u")]))
    xs, ys = unc.step_runner._surrogate_batch(gen, 32)
    assert xs.shape == (32, 28, 28, 1) and ys is None


def test_a_class_without_public_rows_raises(tmp_path):
    opt = toptions.parse(MNIST + ["-pss", "10", "--platform", "cpu", "-o", str(tmp_path)])
    tr = Trainer(opt)
    keep = tr.public.labels != 4
    from csl_gan_tpu_torch.training.segment_runner import PublicRows
    pub = PublicRows(tr.public.images[keep], tr.public.labels[keep], 10)
    with pytest.raises(ValueError, match="no row of class 4"):
        pub.class_matched(torch.Generator(), torch.tensor([1, 4]))


@pytest.mark.parametrize("argv,message", [
    (MNIST + ["-pss", "20", "-nms", "1", "--mean_sample_size", "4"],
     "Both public data partition and mean samples were configured"),
    (MNIST + ["-gcm", "adaptive"], "Adaptive clipping derives its thresholds from public data"),
    (MNIST + ["-gcm", "adaptive-pl"], "Adaptive clipping derives its thresholds from public data"),
    (CELEBA + ["-gcm", "adaptive", "-pss", "8", "-nms", "1", "--mean_sample_size", "2"],
     "Both public data partition and mean samples were configured"),
])
def test_new_option_rules_raise_the_jax_messages(tmp_path, argv, message):
    for parse, extra in ((joptions.parse, []), (toptions.parse, ["--platform", "cpu"])):
        with pytest.raises(Exception, match=message):
            parse(argv + extra + ["-o", str(tmp_path)])


@pytest.mark.parametrize("argv,on_k1", [
    (MNIST, True),
    (MNIST + ["-bs", "50", "-tss", "200"], False),
    (MNIST + ["-bs", "40", "-tss", "200"], True),
    (MNIST + ["-gcm", "adaptive", "-pss", "20"], False),
    (MNIST + ["-gcm", "adaptive-pl", "-nms", "1", "--mean_sample_size", "4"], False),
    (MNIST + ["-nms", "2", "--mean_sample_size", "4", "-wi", "2"], True),
    (MNIST + ["-pss", "20"], True),
    (MNIST + ["--poisson", "true"], False),
    (MNIST + ["--backprop_clip", "true"], False),
])
def test_k1_path_equals_supports(tmp_path, argv, on_k1):
    opt = toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path)])
    tr = Trainer(opt)
    assert toptions._k1_path(opt) == pallas_epoch.supports(tr.builder, opt.use_dp, 1) == on_k1
    assert isinstance(tr.runner, EpochsRunner if on_k1 else StepRunner)
    assert isinstance(tr.step_runner, StepRunner)
