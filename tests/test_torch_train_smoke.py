"""The config smoke matrix of tests/test_train_smoke.py (the reference's
test_configs.sh) through the port's CLI (``python -m
csl_gan_tpu_torch.train``) with ``--platform cpu``, on synthetic MNIST:
each case trains and writes the files the JAX matrix asserts, ``-p`` (its
trace under ``profile/``) and ``--group_fakes`` (with ``--n_d_steps 2``)
among them.
"""

import csv
import os

import pytest
import torch

from csl_gan_tpu_torch import train as port_train

os.makedirs("output", exist_ok=True)

BASE = ["-tss", "200", "-ne", "1", "-bs", "50", "--manual_seed", "2",
        "--log_every", "200", "--sample_every", "100000", "--save_every", "1",
        "--sample_num", "10", "--platform", "cpu"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def run(tmp_path, name, *argv):
    out = str(tmp_path / name)
    port_train.main(["MNIST", *BASE, *argv, "-o", out])
    out += "/"
    assert os.path.exists(out + "opt.txt")
    assert os.path.exists(out + "log.csv")
    assert os.path.exists(out + "saves/G-1")
    assert os.path.exists(out + "saves/D-1")
    return out


def _rows(path):
    with open(path) as f:
        return [r for r in csv.reader(f) if r and r[0] != "Epoch"]


# The matrix's single-run cases: (extra argv, whether privacy_log.csv exists).
CASES = {
    "nonprivate": ([], False),
    "conditional": (["--conditional"], False),
    "gc": (["-dpm", "gc", "-nms", "1", "--mean_sample_size", "10"], True),
    "gc-conditional": (["-dpm", "gc", "--conditional", "-nms", "1", "--mean_sample_size", "10"],
                       True),
    "is": (["-dpm", "is"], True),
    "is-conditional": (["-dpm", "is", "--conditional"], True),
    "tm": (["-dpm", "tm"], True),
    "sv": (["-dpm", "sv"], True),
    "warmup-with-mean-samples": (["-dpm", "gc", "-nms", "2", "--mean_sample_size", "10",
                                  "-wi", "2"], True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mnist_config(tmp_path, name):
    extra, private = CASES[name]
    out = run(tmp_path, name, *extra)
    assert os.path.exists(out + "privacy_log.csv") == private
    assert len(_rows(out + "log.csv")) == 1


def test_mnist_epsilon_budget_stops(tmp_path):
    out = str(tmp_path / "budget")
    port_train.main(["MNIST", "-tss", "200", "-ne", "50", "-bs", "50",
                     "--manual_seed", "2", "--log_every", "100000",
                     "--sample_every", "100000", "--save_every", "100",
                     "-dpm", "gc", "--sigma", "0.5", "-eb", "0.3", "--platform", "cpu",
                     "-o", out])
    with open(out + "/privacy_log.csv") as f:
        rows = list(csv.reader(f))
    # stopped well before 50 epochs
    assert len(rows) < 20


def test_mnist_dcresnet_gc_conditional(tmp_path):
    """The DCResNet pair through the conv-ghost route, WGAN losses and the
    threshold gate (4 D steps of 25 rows)."""
    out = str(tmp_path / "dcrn")
    port_train.main(["MNIST", "--model", "DeepConvResNet", "-tss", "100",
                     "-ne", "1", "-bs", "25", "--manual_seed", "2",
                     "-dpm", "gc", "--conditional", "-nms", "1",
                     "--mean_sample_size", "5", "--log_every", "100",
                     "--sample_every", "100000", "--save_every", "1",
                     "--sample_num", "4", "--platform", "cpu", "-o", out])
    assert os.path.exists(out + "/saves/G-1")
    assert os.path.exists(out + "/privacy_log.csv")


def test_seed_replay_is_deterministic(tmp_path):
    """Two CLI runs with the same --manual_seed write bit-identical
    checkpoints and logs."""
    outs = [run(tmp_path, name, "-dpm", "gc", "--conditional") for name in ("a", "b")]
    with open(outs[0] + "saves/G-1", "rb") as f1, open(outs[1] + "saves/G-1", "rb") as f2:
        assert f1.read() == f2.read()
    with open(outs[0] + "log.csv") as f1, open(outs[1] + "log.csv") as f2:
        assert f1.read() == f2.read()


def test_stop_on_g_freeze(tmp_path):
    """--stop_on_g_freeze N ends training after N consecutive logging
    intervals with zero G updates and writes the normal final checkpoint;
    without the flag the same config runs all epochs frozen."""
    base = ["MNIST", "-dpm", "gc", "-tss", "200", "-bs", "50",
            "--manual_seed", "2", "-ne", "6", "--log_every", "200",
            "--sample_every", "100000", "--save_every", "100",
            "--train_d_until_threshold=-1e9", "--platform", "cpu"]
    out = str(tmp_path / "freeze")
    port_train.main([*base, "--stop_on_g_freeze", "2", "-o", out])
    assert len(_rows(out + "/log.csv")) == 2          # stopped after 2 frozen intervals
    assert os.path.exists(out + "/saves/G-2")         # normal final save written

    out2 = str(tmp_path / "nofreeze")
    port_train.main([*base, "-o", out2])
    assert len(_rows(out2 + "/log.csv")) == 6         # runs to n_epochs


@pytest.mark.parametrize("extra,flag", [
    (["-p"], "--profile_training"),
    (["--n_d_steps", "2", "--group_fakes", "true"], "--group_fakes"),
])
def test_matrix_flags_profile_and_group_fakes(tmp_path, extra, flag):
    """The two matrix flags a later slice ported train like the other cases;
    ``-p`` also leaves its trace."""
    out = run(tmp_path, flag.strip("-"), *extra)
    assert len(_rows(out + "log.csv")) == 1
    assert os.path.exists(out + "profile/trace.json") == (flag == "--profile_training")
