"""The port's Trainer and CLI options on the CPU (--platform cpu), at a tiny
size: one epoch writes log.csv and privacy_log.csv with finite values, its
epsilon equals the JAX package's accountant for the same steps (plus the
mean samples' privacy cost on the DCResNet path), the DCResNet step runner
updates G exactly on the n_d_steps cadence points, every flag that selects
a route of the gc D step trains through the step runner (``--pallas true``
on K6's plain version, reproducibly), and the port refuses to fall back to
the CPU or to ignore an unported flag."""

import csv
import os

import numpy as np
import pytest
import torch

from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant
from csl_gan_tpu.privacy.mean_sampler import MeanSampler as JaxMeanSampler
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.ops import pallas_clip, pallas_epoch
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
    (["-gcm", "adaptive-pl"], "--grad_clip_mode"),
    (["-wd", "0.1"], "--weight_decay"),
    (["--backprop_clip", "true"], "--backprop_clip"),
    (["-rp", "/nonexistent"], "--resume_path"),
    (["--fsdp", "true"], "--fsdp"),
    (["--tp", "2"], "--tp"),
    (["--u8_table", "true"], "--u8_table"),
    (["--mesh_shape", "2"], "--mesh_shape"),
    (["--multihost", "true"], "--multihost"),
    (["-nms", "1"], "--num_mean_samples"),
    (["-pss", "10"], "--public_set_size"),
    (["-wi", "5"], "--warmup_iter"),
    (["--host_loop", "true"], "--host_loop"),
    (["--bf16", "true"], "--bf16"),
    (["--group_fakes", "true"], "--group_fakes"),
    (["--ref_pixel_shuffle", "true"], "--ref_pixel_shuffle"),
    (["-p"], "--profile_training"),
    (["--download_mnist"], "--download_mnist"),
    (["--log_every", "32"], "--log_every"),
    (["--stop_on_g_freeze", "3"], "--stop_on_g_freeze"),
    (["--conditional_arch", "CGAN"], "--conditional_arch"),
    (["--aux_loss_type", "wasserstein"], "--aux_loss_type"),
    (["-bs", "20"], "--batch_size"),
])
def test_unported_flags_raise(tmp_path, extra, flag):
    with pytest.raises(NotImplementedError, match=flag):
        toptions.parse(TINY + extra + ["--platform", "cpu", "-o", str(tmp_path)])


# Flag combinations that the step runner serves, each with the route the gc D
# step must take for it.
DCRN_ON = DCRN + ["--train_d_until_threshold", "1e18"]     # G never gated off
STEP_RUNNER_FLAGS = {
    "pallas-combined": (TINY + ["--pallas", "true", "--grad_clip_split", "false"], "fused"),
    "combined": (TINY + ["--grad_clip_split", "false"], "materialized"),
    "chunk": (TINY + ["--per_sample_chunk", "5"], "materialized"),
    "pallas-with-chunk": (TINY + ["--pallas", "true", "--per_sample_chunk", "5"],
                          "materialized"),
    "pallas-epoch-off": (TINY + ["--pallas_epoch", "false"], "ghost"),
    "pallas-ghost-wins": (TINY + ["--pallas", "true", "--pallas_epoch", "false"], "ghost"),
    "n-d-steps": (TINY + ["--n_d_steps", "2"], "ghost"),
    "threshold": (TINY + ["--train_d_until_threshold", "0.5"], "ghost"),
    "per-layer": (TINY + ["-gcm", "constant-pl", "-cpl", "1", "2", "3", "4", "5", "6"], "ghost"),
    "per-layer-pallas": (TINY + ["-gcm", "constant-pl", "--grad_clip_split", "false",
                                 "--pallas", "true"], "fused"),
    "dcresnet-two-pass": (DCRN_ON + ["--conv_ghost", "false"], "two_pass"),
    "dcresnet-bf16-pallas": (DCRN_ON + ["--conv_ghost", "false", "--bf16", "true",
                                        "--pallas", "true"], "fused"),
    "dcresnet-per-layer": (DCRN_ON + ["-gcm", "constant-pl"], "conv_ghost"),
    "dcresnet-chunk": (DCRN_ON + ["--per_sample_chunk", "3"], "materialized"),
}


@pytest.mark.parametrize("name", list(STEP_RUNNER_FLAGS))
def test_step_runner_flags_train_an_epoch(tmp_path, name):
    """Each combination parses, takes the step runner and its route, trains an
    epoch on the CPU and logs the JAX accountant's epsilon."""
    args, route = STEP_RUNNER_FLAGS[name]
    out = tmp_path / "run"
    tss = int(args[args.index("-tss") + 1])
    opt = toptions.parse(args + ["-ne", "1", "--log_every", str(tss), "--platform", "cpu",
                                 "-o", str(out)])
    tr = Trainer(opt)
    b = tr.builder
    assert isinstance(tr.runner, StepRunner)
    assert {"fused": b.fused_route, "materialized": b.materialized and not b.fused_route,
            "ghost": b.use_ghost, "two_pass": b.use_two_pass,
            "conv_ghost": b.use_conv_ghost}[route]
    launches = pallas_clip.leaf_weighted_sum_noise.launches
    assert tr.run() == 0
    # On the CPU the fused route runs K6's plain version: no launch is counted.
    assert pallas_clip.leaf_weighted_sum_noise.launches == launches
    assert tr.state.d_count == tr.n_batches
    assert tr.state.g_count == (0 if name == "threshold" else -(-tr.n_batches // opt.n_d_steps))
    with open(out / "log.csv") as f:
        row = list(csv.DictReader(f))[-1]
    for k in ("D Adv Loss", "D Real Loss", "D Fake Loss", "D Real Aux Loss"):
        assert np.isfinite(float(row[k])), k
    n_leaves = len(b.d_leaves)
    clip = np.asarray(row["Clipping Params"].strip("[]").split(), np.float32)
    assert clip.size == (n_leaves if b.per_layer else 1)
    if name == "per-layer":      # -cpl is in torch order, and so is the log column
        np.testing.assert_allclose(clip, [1, 2, 3, 4, 5, 6])
        assert tr.state.clipping == (2.0, 1.0, 4.0, 3.0, 6.0, 5.0)
    with open(out / "privacy_log.csv") as f:
        eps = float(list(csv.DictReader(f))[-1]["Epsilon"])
    ref = JaxRdpAccountant(batch_size=opt.batch_size, sample_size=tss,
                           noise_multiplier=opt.sigma)
    ref.step(tr.n_batches)
    np.testing.assert_allclose(eps - tr.mean_sample_privacy_cost,
                               ref.get_privacy_spent(opt.delta)[0], rtol=1e-9)
    for t in list(tr.state.d_params.values()) + list(tr.state.g_params.values()):
        assert torch.isfinite(t).all()


def test_pallas_true_on_the_cpu_is_reproducible(tmp_path):
    """--pallas true on CPU tensors takes K6's plain version; the Philox
    stream is a function of the drawn seeds, so one seed gives one result."""
    args = STEP_RUNNER_FLAGS["pallas-combined"][0] + ["-ne", "1", "--log_every", "160", "--platform", "cpu"]
    runs = []
    for tag, seed in (("a", "3"), ("b", "3"), ("c", "4")):
        tr = Trainer(toptions.parse(args + ["--manual_seed", seed, "-o", str(tmp_path / tag)]))
        tr.run()
        runs.append(tr.state.d_params)
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    assert any(not torch.equal(runs[0][k], runs[2][k]) for k in runs[0])


def test_not_ported_names_only_unported_flags():
    """The flags of STEP_RUNNER_FLAGS are off the refusal list; the options
    still outside the port are on it."""
    names = [flag for flag, _ in toptions._NOT_PORTED]
    for lifted in ("--pallas", "--per_sample_chunk", "--grad_clip_split", "--conv_ghost",
                   "--clipping_param_per_layer", "--n_d_steps", "--train_d_until_threshold"):
        assert not any(lifted in n for n in names), lifted
    for kept in ("--dp_mode", "--poisson", "adaptive", "-pupd", "DRAGAN", "--backprop_clip",
                 "--weight_decay", "unconditional", "CGAN / WCGAN", "--resume_path",
                 "--fsdp", "--tp", "--mesh_shape", "--multihost"):
        assert any(kept in n for n in names), kept


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
