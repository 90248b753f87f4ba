"""The MNIST DCResNet pair's unconditional, CGAN, WCGAN and embedded-G runs
through the port's Trainer on the CPU under the is (flat, per parameter,
constant-pl), tm and sv engines: one epoch of 5 D steps each, checked by
tests/torch_conditional_cases.py ``check_variant_epoch`` (the JAX log
header, accountant and mean sampler)."""

import os

import pytest
import torch
from torch_conditional_cases import CASES, check_variant_epoch

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


NAMES = [n for n in CASES if n.startswith("dcresnet-")
         and ("-is" in n or n.endswith(("-tm", "-sv")))]

@pytest.mark.parametrize("name", NAMES)
def test_variant_trains_an_epoch_with_the_jax_log_and_epsilon(tmp_path, name):
    check_variant_epoch(tmp_path, name)
