"""The DCResNet gc path through the port's Trainer on the CPU: the flag
combinations that select a route of its D step (tests/torch_trainer_cases.py
STEP_RUNNER_FLAGS) each train an epoch on their route and log the JAX
accountant's epsilon, and the step runner updates G exactly on the
n_d_steps cadence points with epsilon the JAX accountant's plus the JAX mean
sampler's cost."""

import csv
import os

import numpy as np
import pytest
import torch

from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant
from csl_gan_tpu.privacy.mean_sampler import MeanSampler as JaxMeanSampler
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import StepRunner
from torch_trainer_cases import DCRN, STEP_RUNNER_FLAGS, check_step_runner_epoch

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", [n for n in STEP_RUNNER_FLAGS if n.startswith("dcresnet")])
def test_step_runner_flags_train_an_epoch(tmp_path, name):
    """Each combination parses, takes the step runner and its route, trains an
    epoch on the CPU and logs the JAX accountant's epsilon."""
    check_step_runner_epoch(tmp_path, name)


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
