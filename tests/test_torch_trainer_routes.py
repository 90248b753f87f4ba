"""The flag combinations of the MNIST vanilla model that select a route of
the gc D step (tests/torch_trainer_cases.py STEP_RUNNER_FLAGS): each trains
an epoch through the port's step runner on the CPU, on its route, and logs
the JAX accountant's epsilon."""

import os

import pytest
import torch
from torch_trainer_cases import STEP_RUNNER_FLAGS, check_step_runner_epoch

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("name", [n for n in STEP_RUNNER_FLAGS if not n.startswith("dcresnet")])
def test_step_runner_flags_train_an_epoch(tmp_path, name):
    """Each combination parses, takes the step runner and its route, trains an
    epoch on the CPU and logs the JAX accountant's epsilon."""
    check_step_runner_epoch(tmp_path, name)
