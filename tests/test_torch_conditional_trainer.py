"""The port's Trainer on unconditional runs and the CGAN, WCGAN and
embedded-G variants, on the CPU (--platform cpu), at a tiny size. Here: one
epoch of each variant on the MNIST vanilla model at TINY's size (5 D steps
of 32 rows) under every D-step engine of the port (gc on the ghost route,
is, tm, sv, and no DP) and on the fused gc route and the per-parameter and
constant-pl is variants; the MNIST DCResNet pair's runs are in
tests/test_torch_conditional_trainer_{dcresnet,dp}.py. Each run
(tests/torch_conditional_cases.py ``check_variant_epoch``) writes the
``log.csv`` header the JAX Trainer writes for the same options (its
``build_logger``: the aux columns follow ``use_aux_loss``) with finite
values, epsilon the JAX accountant's for the same steps plus the JAX mean
sampler's cost, and its saves; the MNIST table and the sample grid carry
labels exactly when the run is conditional. A vanilla WCGAN run trains
exactly as the CGAN one. The evaluation tools on the variants' saves and
resume across packages: tests/test_torch_conditional_tools.py.
"""

import os

import pytest
import torch

from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.training.loop import Trainer
from torch_conditional_cases import CASES, TINY, check_variant_epoch

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


NAMES = [n for n in CASES if n.startswith("vanilla-")]

@pytest.mark.parametrize("name", NAMES)
def test_variant_trains_an_epoch_with_the_jax_log_and_epsilon(tmp_path, name):
    check_variant_epoch(tmp_path, name)


def test_vanilla_wcgan_trains_as_cgan(tmp_path):
    """The vanilla D has no per-class head (the JAX package's and the
    reference's MNIST D), so a WCGAN run of the vanilla model trains exactly
    the CGAN run's losses: the same state after an epoch; its log adds the
    aux columns, at 0."""
    states = []
    for arch in ("CGAN", "WCGAN"):
        tr = Trainer(toptions.parse(TINY + ["-dpm", "gc", "--conditional", "--conditional_arch",
                                            arch, "-ne", "1", "--log_every", "160",
                                            "--platform", "cpu", "-o", str(tmp_path / arch)]))
        tr.run()
        states.append(tr.state)
    for field in ("d_params", "g_params", "d_mu", "g_nu"):
        a, b = getattr(states[0], field), getattr(states[1], field)
        assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a), field
