"""The port's image files (csl_gan_tpu_torch/utils/images.py, PNGs by zlib
and struct) against the JAX package's (PIL): the same pixels for the same
arrays, grey and RGB, single images and grids with a remainder row;
``read_png`` reads both packages' files; the Trainer writes its fixed-z
grids at an epoch cadence (epochs runner) and a sub-epoch cadence (step
runner), refuses the sub-epoch cadence on the K1 path by name, and writes
the mean-sample PNGs as the JAX package does."""

import numpy as np
import pytest
from PIL import Image

from csl_gan_tpu.privacy.mean_sampler import MeanSampler as JaxMeanSampler
from csl_gan_tpu.utils import images as jimages
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.privacy.mean_sampler import MeanSampler
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner, StepRunner
from csl_gan_tpu_torch.utils import images

RNG = np.random.default_rng(7)
ARRAYS = {
    "grey": ("image", RNG.random((28, 28, 1)).astype(np.float32)),
    "rgb": ("image", RNG.random((64, 64, 3)).astype(np.float32)),
    "clamped": ("image", RNG.normal(0.5, 0.8, (20, 33, 3)).astype(np.float32)),
    "grid-grey-remainder": ("grid", RNG.random((7, 28, 28, 1)).astype(np.float32)),
    "grid-rgb-remainder": ("grid", RNG.random((5, 16, 12, 3)).astype(np.float32)),
    "grid-smooth": ("grid", np.tile(np.linspace(0, 1, 48, dtype=np.float32),
                                    (4, 48, 1))[..., None].repeat(3, -1)),
}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_same_pixels_as_the_jax_package(tmp_path, name):
    kind, arr = ARRAYS[name]
    jp, pp = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    if kind == "image":
        jimages.save_image(arr, jp)
        images.save_image(arr, pp)
    else:
        jimages.save_image_grid(arr, jp, nrow=3)
        images.save_image_grid(arr, pp, nrow=3)
    want = np.asarray(Image.open(jp))
    assert np.array_equal(np.asarray(Image.open(pp)), want)
    # read_png reads PIL's file (adaptive row filters) and the port's (filter 0).
    assert np.array_equal(images.read_png(jp), want)
    assert np.array_equal(images.read_png(pp), want)


def test_read_png_refuses_what_it_cannot_read(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "16bit.png")
    with pytest.raises(ValueError, match="bit depth 16"):
        images.read_png(str(tmp_path / "16bit.png"))
    (tmp_path / "x.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        images.read_png(str(tmp_path / "x.png"))
    with pytest.raises(ValueError, match="uint8"):
        images.write_png(np.zeros((4, 4), np.float32), str(tmp_path / "f.png"))


class _Batches:
    """A deterministic stand-in for the mean sampler's data loader."""

    def __init__(self, ch):
        self.rng = np.random.default_rng(3)
        self.ch = ch

    def one_batch(self):
        x = self.rng.uniform(-1, 1, (12, 8, 8, self.ch)).astype(np.float32)
        return x, np.arange(12) % 2


@pytest.mark.parametrize("ch", [1, 3])
def test_mean_sample_pngs_equal_the_jax_packages(tmp_path, ch):
    kw = dict(noise_std=0.1, num_samples=3, mean_size=4, dataset_size=100, res=8, ch=ch,
              n_classes=2, seed=5)
    JaxMeanSampler(dataloader=_Batches(ch), save_path=str(tmp_path / "jax"), **kw)
    port = MeanSampler(dataloader=_Batches(ch), save_path=str(tmp_path / "port"), **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == [f"{c}-{i}.png" for c in range(2) for i in range(1, 4)]
    for n in names:
        want = np.asarray(Image.open(tmp_path / "jax" / n))
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / n)), want), n
    assert port.mean_samples.shape == (2, 3, 8, 8, ch)


def test_epoch_cadence_grids_on_the_epochs_runner(tmp_path):
    out = tmp_path / "run"
    opt = toptions.parse(["MNIST", "--conditional", "-dpm", "gc", "-bs", "32", "-tss", "160",
                          "-ne", "2", "--log_every", "160", "--sample_every", "160",
                          "--platform", "cpu", "--manual_seed", "3", "-o", str(out)])
    tr = Trainer(opt)
    assert tr.fixed_z.shape == (100, 100) and tr.fixed_y.tolist() == list(range(10)) * 10
    tr.run()
    assert sorted(p.name for p in (out / "samples").iterdir()) == ["1-4.png", "2-4.png"]
    px = images.read_png(str(out / "samples" / "2-4.png"))
    assert px.shape == (10 * 30 + 2, 10 * 30 + 2)          # 10 x 10 grey, 2 px padding


def test_sub_epoch_cadence_grids_on_the_step_runner(tmp_path):
    out = tmp_path / "run"
    opt = toptions.parse(["CelebA", "--conditional", "-dpm", "gc", "-bs", "8", "-tss", "16",
                          "-nms", "1", "--mean_sample_size", "2", "--bf16", "true",
                          "--train_d_until_threshold", "1e18", "-ne", "1",
                          "--log_every", "16", "--sample_every", "8", "--platform", "cpu",
                          "--manual_seed", "3", "-o", str(out)])
    tr = Trainer(opt)
    assert tr.fixed_y.tolist() == [0, 1] * 12 and tr.fixed_z.shape == (24, 128)
    tr.run()
    assert sorted(p.name for p in (out / "samples").iterdir()) == ["1-0.png", "1-1.png"]
    px = images.read_png(str(out / "samples" / "1-1.png"))
    assert px.shape == (12 * 66 + 2, 2 * 66 + 2, 3)        # 24 RGB images, 2 a row
    # The last grid is G at the end state, as sample_images gives it.
    imgs = tr.builder.sample_images(tr.state, tr.fixed_z, tr.fixed_y).numpy()
    images.save_image_grid(images.denorm_celeba(imgs), str(tmp_path / "want.png"), nrow=2)
    assert np.array_equal(px, images.read_png(str(tmp_path / "want.png")))
    assert sorted(p.name for p in (out / "mean_samples").iterdir()) == ["0-1.png", "1-1.png"]
    assert images.read_png(str(out / "mean_samples" / "0-1.png")).shape == (64, 64, 3)


def test_sub_epoch_cadence_on_the_k1_path(tmp_path):
    """A sub-epoch --sample_every on the K1 path parses and cuts each epoch
    into segments, one K1 call each (its plain version on the CPU), with a
    grid at each sample point; the step runner takes it too."""
    args = ["MNIST", "--conditional", "-dpm", "gc", "-bs", "32", "-tss", "160",
            "--sample_every", "64", "--platform", "cpu", "-ne", "1"]
    opt = toptions.parse(args + ["-o", str(tmp_path / "k1")])
    assert opt.sample_every_epochs < 0 and opt.sample_every == 64
    tr = Trainer(opt)
    assert isinstance(tr.runner, EpochsRunner) and tr._epoch_cuts() == [2, 4, 5]
    tr.run()
    assert sorted(p.name for p in (tmp_path / "k1" / "samples").iterdir()) == \
        ["1-1.png", "1-3.png"]
    assert tr.state.d_count == tr.state.g_count == 5
    opt = toptions.parse(args + ["--pallas_epoch", "false", "-o", str(tmp_path / "sr")])
    tr = Trainer(opt)
    assert isinstance(tr.runner, StepRunner)
    tr.run()
    assert sorted(p.name for p in (tmp_path / "sr" / "samples").iterdir()) == \
        ["1-1.png", "1-3.png"]
