"""The port's Trainer and CLI options on the CPU (--platform cpu), at a tiny
size: one epoch writes log.csv and privacy_log.csv with finite values, its
epsilon equals the JAX package's accountant for the same steps, and the
port refuses to fall back to the CPU or to ignore an unported flag."""

import csv

import numpy as np
import pytest
import torch

from csl_gan_tpu.privacy import RdpAccountant as JaxRdpAccountant
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.ops import pallas_epoch
from csl_gan_tpu_torch.training.loop import Trainer

TINY = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-bs", "32",
        "-tss", "160", "--manual_seed", "3"]


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
    with pytest.raises(NotImplementedError, match="CelebA"):
        toptions.parse(["CelebA", "-dpm", "gc", "-o", str(tmp_path)])
