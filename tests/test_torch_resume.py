"""Resume in the port's Trainer (--resume_path, on the CPU):

- two epochs in one run are bitwise equal, saves and logs, to one epoch and
  one more resumed from its save, on the epochs runner (MNIST, K1's plain
  epoch) and on the step runner (CelebA at -bs 8 -tss 16, sub-epoch sample
  grids on); each CSV keeps one header;
- across packages, both ways: a run of the JAX package's train.py resumed by
  the port, and a run of the port resumed by train.py; epsilon continues and
  its last row equals an RdpAccountant of the total steps. A JAX save holds no
  torch generator states: the port seeds them from (seed, resume epoch), a
  stream no fresh run draws, and says so.
"""

import csv
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import train as jax_train  # noqa: E402
from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant  # noqa: E402
from csl_gan_tpu_torch import options as toptions  # noqa: E402
from csl_gan_tpu_torch import train as port_train  # noqa: E402
from csl_gan_tpu_torch.training import checkpoint  # noqa: E402
from csl_gan_tpu_torch.training.loop import Trainer  # noqa: E402

RUNS = {
    "mnist-epochs-runner": (["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7",
                             "-bs", "32", "-tss", "160", "--log_every", "160"], "MNIST"),
    "celeba-step-runner": (["CelebA", "--conditional", "-dpm", "gc", "-bs", "8", "-tss", "16",
                            "-nms", "1", "--mean_sample_size", "2", "--bf16", "true",
                            "--train_d_until_threshold", "1e18", "--log_every", "16",
                            "--sample_every", "8"], "CelebA"),
}
# The JAX run of the cross-package tests: -bs 40, since the port refuses batch
# sizes that are not a multiple of 8.
CROSS = ["MNIST", "--conditional", "-dpm", "gc", "-tss", "200", "-bs", "40",
         "--manual_seed", "2", "--log_every", "200", "--save_every", "1",
         "--platform", "cpu"]


def _rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _one_header(path):
    rows = _rows(path)
    assert rows[0][0] == "Epoch" and sum(r[:1] == ["Epoch"] for r in rows) == 1, path
    return rows[1:]


@pytest.mark.parametrize("name", list(RUNS))
def test_two_epochs_equal_one_plus_one_resumed(tmp_path, name):
    args, dataset = RUNS[name]
    a, b = tmp_path / "a", tmp_path / "b"
    common = args + ["--platform", "cpu", "--manual_seed", "3"]
    port_train.main(common + ["-ne", "2", "-o", str(a)])
    port_train.main(common + ["-ne", "1", "-o", str(b)])
    resume = [dataset, "-rp", str(b), "-re", "1", "-ne", "2", "-ka", "n_epochs",
              "--platform", "cpu"]
    tr = Trainer(toptions.parse(resume))
    _, _, _, run_state = checkpoint.load_d(str(b / "saves" / "D-1"), tr.state)
    assert tr.start_epoch == 1 and tr.accountant.steps == tr.n_batches
    assert checkpoint.generator_state(tr.gen) == run_state["gen"]
    if dataset == "CelebA":       # the threshold gate's carry came back too
        assert torch.equal(tr.runner.d_acc, torch.tensor(run_state["d_acc"]))
    tr.run()
    for f in ("G-2", "D-2"):
        assert (a / "saves" / f).read_bytes() == (b / "saves" / f).read_bytes(), f
    for f in ("log.csv", "privacy_log.csv"):
        assert _one_header(a / f) == _one_header(b / f), f
    assert len(_rows(b / "privacy_log.csv")) == 3
    assert sorted(os.listdir(a / "samples")) == sorted(os.listdir(b / "samples"))
    assert (b / "code" / "csl_gan_tpu_torch" / "training" / "loop.py").is_file()


def _eps_rows(path):
    return [float(r[1]) for r in _one_header(path)]


def _expected_eps(steps):
    acc = JaxRdpAccountant(40, 200, 5.0)
    acc.step(steps)
    return acc.get_privacy_spent(1e-5)[0]


def test_jax_run_resumed_by_the_port(tmp_path, capsys):
    out = tmp_path / "jax"
    jax_train.main(CROSS + ["-ne", "2", "-o", str(out)])
    resume = ["MNIST", "-rp", str(out), "-re", "2", "-ne", "3", "-ka", "n_epochs",
              "--platform", "cpu"]
    tr = Trainer(toptions.parse(resume))
    assert "holds no generator states" in capsys.readouterr().out
    fresh = torch.Generator().manual_seed(2 * 2)
    assert tr.gen.get_state().numpy().tobytes() != fresh.get_state().numpy().tobytes()
    tr.run()
    eps = _eps_rows(out / "privacy_log.csv")
    assert len(eps) == 3 and eps[0] < eps[1] < eps[2]
    assert eps[-1] == _expected_eps(3 * 5)
    _one_header(out / "log.csv")
    assert (out / "saves" / "G-3").exists() and (out / "saves" / "D-3").exists()


def test_port_run_resumed_by_jax(tmp_path):
    out = tmp_path / "port"
    port_train.main(CROSS + ["-ne", "2", "-o", str(out)])
    jax_train.main(["MNIST", "-rp", str(out), "-re", "2", "-ne", "3", "-ka", "n_epochs"])
    eps = _eps_rows(out / "privacy_log.csv")
    assert len(eps) == 3 and eps[0] < eps[1] < eps[2]
    assert eps[-1] == _expected_eps(3 * 5)
    _one_header(out / "log.csv")
    assert (out / "saves" / "G-3").exists()
