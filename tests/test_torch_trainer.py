"""The port's Trainer and CLI options on the CPU (--platform cpu), at a tiny
size: one epoch writes log.csv and privacy_log.csv with finite values, its
epsilon equals the JAX package's accountant for the same steps (plus the
mean samples' privacy cost on the DCResNet path), the DCResNet step runner
updates G exactly on the n_d_steps cadence points, and the port refuses to
fall back to the CPU or to ignore an unported flag."""

import csv
import os

import numpy as np
import pytest
import torch

from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant
from csl_gan_tpu.privacy.mean_sampler import MeanSampler as JaxMeanSampler
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.ops import pallas_epoch
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import StepRunner

# The JAX package's options.parse creates ./output with a check, then a
# create (csl_gan_tpu/options.py:623-626). Under xdist, two workers whose
# first tests both parse at the same moment race on it and one raises
# FileExistsError (tests/test_models.py::test_mnist_vanilla_shapes_and_counts
# failed so). Every worker collects every test file before it runs a test,
# so creating the directory here, at collection, removes the race.
os.makedirs("output", exist_ok=True)

TINY = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-bs", "32",
        "-tss", "160", "--manual_seed", "3"]
# The CelebA flagship's recipe (DCResNet gc, WGAN-GP on mean samples, G every
# 5th D step) on the MNIST DCResNet pair: 10 D steps of 8 rows per epoch.
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "--sigma", "0.5", "-bs", "8", "-tss", "80",
        "--manual_seed", "4"]
FLAGSHIP = ["CelebA", "--conditional", "-dpm", "gc", "-bs", "128", "-tss", "12800",
            "-nms", "1", "--mean_sample_size", "8", "--bf16", "true",
            "--train_d_until_threshold", "1e18"]


def test_trainer_one_epoch_cpu(tmp_path):
    out = tmp_path / "run"
    opt = toptions.parse(TINY + ["-ne", "1", "--log_every", "160",
                                 "--platform", "cpu", "-o", str(out)])
    tr = Trainer(opt)
    assert tr.device.type == "cpu"
    assert pallas_epoch.supports(tr.builder, True, 1)
    assert tr.table.dtype == torch.bfloat16 and tr.table.shape == (160, 795)
    assert tr.run() == 0
    with open(out / "log.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    for k in ("G Adv Loss", "G Aux Loss", "D Adv Loss", "D Real Loss",
              "D Fake Loss", "D Real Aux Loss"):
        assert np.isfinite(float(rows[0][k])), k
    with open(out / "privacy_log.csv") as f:
        eps_rows = list(csv.DictReader(f))
    assert [int(r["Epoch"]) for r in eps_rows] == [0]
    steps = 160 // 32
    ref = JaxRdpAccountant(batch_size=32, sample_size=160, noise_multiplier=0.7)
    ref.step(steps)
    np.testing.assert_allclose(float(eps_rows[0]["Epsilon"]),
                               ref.get_privacy_spent(1e-5)[0], rtol=1e-12)
    assert tr.state.d_count == tr.state.g_count == steps
    for t in list(tr.state.d_params.values()) + list(tr.state.g_params.values()):
        assert torch.isfinite(t).all()


def test_device_table_matches_jax(tmp_path):
    """The bf16 [x | one-hot | label] table equals the JAX package's bit for
    bit (both round to nearest even), and gather_batch splits its rows."""
    import jax.numpy as jnp
    from csl_gan_tpu import options as joptions
    from csl_gan_tpu.training.loop import Trainer as JaxTrainer

    jt = JaxTrainer(joptions.parse(TINY + ["-o", str(tmp_path / "j")]))
    tt = Trainer(toptions.parse(TINY + ["--platform", "cpu", "-o", str(tmp_path / "t")]))
    jtab = np.asarray(jt._dev_data[0].astype(jnp.float32))
    np.testing.assert_array_equal(tt.table.float().numpy(), jtab)
    idx = torch.tensor([3, 0, 159])
    x, y, oh = tt.builder.gather_batch(tt.table, idx)
    assert x.shape == (3, 28, 28, 1) and x.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), tt.dataset.labels[idx.numpy()])
    np.testing.assert_array_equal(oh.numpy(), np.eye(10, dtype=np.float32)[y.numpy()])
    np.testing.assert_array_equal(x.numpy().reshape(3, -1), jtab[idx.numpy(), :784])


def test_trainer_nondp_cpu(tmp_path):
    opt = toptions.parse(["MNIST", "--conditional", "-bs", "32", "-tss", "160",
                          "-ne", "2", "--platform", "cpu", "-o", str(tmp_path)])
    tr = Trainer(opt)
    assert tr.accountant is None and pallas_epoch.supports(tr.builder, False, 1)
    tr.run()
    assert tr.state.d_count == 10
    assert not (tmp_path / "privacy_log.csv").exists()


@pytest.mark.parametrize("steps", [1, 100, 12345])
def test_epsilon_matches_jax_accountant(steps):
    from csl_gan_tpu_torch.privacy import RdpAccountant

    a, b = RdpAccountant(600, 60000, 10.0), JaxRdpAccountant(600, 60000, 10.0)
    a.step(steps)
    b.step(steps)
    ea, aa = a.get_privacy_spent(1e-5)
    eb, ab = b.get_privacy_spent(1e-5)
    np.testing.assert_allclose(ea, eb, rtol=1e-12)
    assert aa == ab


def test_no_platform_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = toptions.parse(TINY + ["-ne", "1", "-o", str(tmp_path)])
    assert opt.platform is None
    with pytest.raises(RuntimeError, match="--platform cpu"):
        Trainer(opt)


@pytest.mark.parametrize("extra,flag", [
    (["-dpm", "is"], "--dp_mode"),
    (["--penalty", "WGAN-GP"], "--penalty"),
    (["--poisson", "true"], "--poisson"),
    (["-gcm", "adaptive"], "--grad_clip_mode"),
    (["-gcm", "constant-pl"], "--grad_clip_mode"),
    (["-wd", "0.1"], "--weight_decay"),
    (["--n_d_steps", "2"], "--n_d_steps"),
    (["-rp", "/nonexistent"], "--resume_path"),
    (["--fsdp", "true"], "--fsdp"),
    (["--tp", "2"], "--tp"),
    (["--pallas", "true"], "--pallas"),
])
def test_unported_flags_raise(tmp_path, extra, flag):
    with pytest.raises(NotImplementedError, match=flag):
        toptions.parse(TINY + extra + ["--platform", "cpu", "-o", str(tmp_path)])


def test_celeba_raises(tmp_path):
    """The CelebA flagship parses with the CelebA defaults; CelebA
    configurations outside the ported slice raise naming the flag."""
    opt = toptions.parse(FLAGSHIP + ["-o", str(tmp_path / "ok")])
    assert (opt.model, opt.n_d_steps, opt.penalty, opt.aux_loss_type) == \
        ("DeepConvResNet", 5, ["WGAN-GP"], "wasserstein")
    assert (opt.adam_b1, opt.adam_b2, opt.sigma, opt.clipping_param) == (0.0, 0.9, 0.5, 200)
    assert opt.train_d_until_threshold == 1e18 and opt.bf16
    for extra, flag in ((["-dpm", "gc"], "--conditional"),
                        (["--conditional", "-dpm", "is"], "--dp_mode"),
                        (["--conditional", "-dpm", "gc", "--conditional_arch", "WCGAN"],
                         "--conditional_arch"),
                        (["--conditional", "-dpm", "gc", "-nms", "1", "-pupd", "false"],
                         "-pupd"),
                        (["--conditional", "-dpm", "gc", "-nms", "1", "--group_fakes", "true"],
                         "--group_fakes")):
        with pytest.raises(NotImplementedError, match=flag):
            toptions.parse(["CelebA", "-tss", "12800"] + extra + ["-o", str(tmp_path / "no")])


def test_mean_samples_match_jax(tmp_path):
    """The Trainer's mean samples (the penalty's surrogate data) and their
    privacy cost equal the JAX Trainer's on the same dataset and seeds."""
    from csl_gan_tpu import options as joptions
    from csl_gan_tpu.training.loop import Trainer as JaxTrainer

    jt = JaxTrainer(joptions.parse(DCRN + ["-o", str(tmp_path / "j")]))
    tt = Trainer(toptions.parse(DCRN + ["--platform", "cpu", "-o", str(tmp_path / "t")]))
    want = jt.mean_sampler.mean_samples
    assert tt.mean_sampler.mean_samples.shape == want.shape == (10, 1, 28, 28, 1)
    np.testing.assert_array_equal(tt.mean_sampler.mean_samples, want)
    np.testing.assert_allclose(tt.mean_sample_privacy_cost, jt.mean_sample_privacy_cost,
                               rtol=1e-12)


@pytest.mark.parametrize("threshold,g_at", [("1e18", [1, 6]), ("-1e9", [])])
def test_trainer_dcresnet_epoch_cpu(tmp_path, threshold, g_at):
    """One epoch of the DCResNet gc path through the step runner: G updates
    after D steps 0 and 5 (d_count 1 and 6) of 10 with the gating off, none
    when the gate's threshold is below any loss; epsilon is the JAX
    accountant's plus the JAX mean sampler's cost."""
    out = tmp_path / "run"
    opt = toptions.parse(DCRN + ["-ne", "1", "--log_every", "80", "--platform", "cpu",
                                 f"--train_d_until_threshold={threshold}", "-o", str(out)])
    tr = Trainer(opt)
    assert isinstance(tr.runner, StepRunner) and tr.n_batches == 10
    seen = []
    g_step = tr.builder.g_step_dcresnet

    def spy(state, z, y):
        seen.append(state.d_count)
        return g_step(state, z, y)

    tr.builder.g_step_dcresnet = spy
    assert tr.run() == 0
    assert seen == g_at and tr.state.g_count == len(g_at) and tr.state.d_count == 10
    with open(out / "log.csv") as f:
        row = list(csv.DictReader(f))[-1]
    for k in ("D Adv Loss", "D Real Loss", "D Fake Loss", "D Real Aux Loss", "D Penalty"):
        assert np.isfinite(float(row[k])), k
    with open(out / "privacy_log.csv") as f:
        eps = float(list(csv.DictReader(f))[-1]["Epsilon"])
    ref = JaxRdpAccountant(batch_size=8, sample_size=80, noise_multiplier=0.5)
    ref.step(10)
    cost, _ = JaxMeanSampler(noise_std=opt.mean_sample_noise_std, num_samples=1,
                             mean_size=4, dataset_size=80, res=28, ch=1, n_classes=10,
                             smallest_class_size=80 / 10).get_privacy_cost(opt.delta)
    np.testing.assert_allclose(eps, ref.get_privacy_spent(opt.delta)[0] + cost, rtol=1e-12)
    for t in list(tr.state.d_params.values()) + list(tr.state.g_params.values()):
        assert torch.isfinite(t).all()
