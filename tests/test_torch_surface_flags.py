"""The single-device flags of the port beside ``-wd`` and ``--group_fakes``
(tests/test_torch_weight_decay.py, tests/test_torch_group_fakes.py), on the
CPU, each against the JAX package where it has a counterpart:

  - ``--u8_table``: the device table's bytes equal the JAX Trainer's
    (training/loop.py:312-333), the dequantized batch is within one fp32
    ulp of the fp32 pixels it stores, and the three messages are the JAX
    package's;
  - ``--bf16`` on the vanilla model: the MLP computes fp32 whatever the
    flag, so one gc step equals the JAX package's bf16 step as the fp32
    steps do (2e-3 normalized l2, tests/test_torch_gc_step.py's bound), and
    the run leaves K1;
  - a sub-epoch ``--log_every``: ``log.csv``'s rows, their epochs and epoch
    progress, and ``privacy_log.csv`` equal the JAX Trainer's on one argv;
    on the K1 path the epoch runs as segments;
  - ``--host_loop`` on CelebA: batches from the host loader, no device
    table, finite logs; the JAX Trainer's ``--poisson`` refusal there;
  - a single-class conditional ``opt.txt`` (n_classes has no flag) trains
    and resumes;
  - a wasserstein aux loss on the conditional vanilla model raises the JAX
    package's message;
  - ``-p`` writes the trace under ``profile/`` and prints the key-averages
    table and the section summary.
"""

import csv
import json
import os

import numpy as np
import pytest
import torch

from csl_gan_tpu import options as joptions
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.data import ArrayDataset
from csl_gan_tpu_torch.training import loop as tloop
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner, StepRunner

os.makedirs("output", exist_ok=True)

MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-bs", "32",
         "-tss", "160", "--manual_seed", "3"]
CELEBA = ["CelebA", "--conditional", "-dpm", "gc", "-bs", "8", "-tss", "16", "-nms", "1",
          "--mean_sample_size", "2", "--bf16", "true", "--train_d_until_threshold", "1e18",
          "-ne", "1", "--log_every", "16", "--manual_seed", "3"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_u8_table_bytes_match_jax(tmp_path, capsys):
    from csl_gan_tpu.training.loop import Trainer as JaxTrainer

    argv = MNIST + ["--u8_table", "true", "-ne", "1"]
    jt = JaxTrainer(joptions.parse(argv + ["-o", str(tmp_path / "j")]))
    jout = capsys.readouterr().out
    tt = Trainer(toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path / "t")]))
    tout = capsys.readouterr().out
    want = np.asarray(jt._dev_data[0])
    assert want.dtype == np.uint8 and want.shape == (160, 785)
    assert tt.table.dtype == torch.uint8
    np.testing.assert_array_equal(tt.table.numpy(), want)
    msg = "pixels are NOT u8-exact"         # synthetic MNIST is not on the 1/255 grid
    assert msg in jout and msg in tout
    assert tt.builder.labels_in_table and not tt.builder.onehot_in_table
    # The dequantized batch against the JAX gather of the same rows.
    idx = np.arange(0, 160, 5)
    jx, jy = jt.builder.gather_batch(jt._dev_data[0], jt._dev_data[1], idx)
    x, y = tt._gather(torch.from_numpy(idx))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_max_ulp(x.numpy(), np.asarray(jx), maxulp=1)


def test_u8_table_round_trips_u8_exact_pixels(tmp_path, monkeypatch, capsys):
    """On pixels that are multiples of 1/255 the table announces the <= 1-ulp
    dequantization, and each gathered pixel is within one ulp of its
    source."""
    rng = np.random.default_rng(0)
    imgs = (rng.integers(0, 256, (160, 28, 28, 1)) / 255.0).astype(np.float32)
    labels = np.repeat(np.arange(10), 16)
    monkeypatch.setattr(tloop, "init_data", lambda opt: (ArrayDataset(imgs, labels), None))
    tt = Trainer(toptions.parse(MNIST + ["--u8_table", "true", "--platform", "cpu",
                                         "-o", str(tmp_path)]))
    assert "<=1-ulp dequant u8/255 after the gather" in capsys.readouterr().out
    idx = torch.arange(160)
    x, y = tt._gather(idx)
    np.testing.assert_array_max_ulp(x.numpy(), imgs, maxulp=1)
    np.testing.assert_array_equal(y.numpy(), labels)


def test_u8_table_is_loud_where_it_does_not_apply(tmp_path, capsys):
    """CelebA's uint8 images are no float table: both packages say so and
    keep their storage."""
    from csl_gan_tpu.training.loop import Trainer as JaxTrainer

    argv = CELEBA + ["--u8_table", "true"]
    JaxTrainer(joptions.parse(argv + ["-o", str(tmp_path / "j")]))
    jout = capsys.readouterr().out
    tt = Trainer(toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path / "t")]))
    tout = capsys.readouterr().out
    msg = "--u8_table requested but not applicable to this dataset"
    assert msg in jout and msg in tout
    assert tt.images.dtype == torch.uint8 and not hasattr(tt, "table")


def test_bf16_vanilla_step_matches_jax(tmp_path):
    """--bf16 on the MNIST vanilla model: both packages' MLPs compute fp32,
    so the bf16 gc step is the fp32 step; the flag only takes K1 off."""
    import jax
    import jax.numpy as jnp

    from csl_gan_tpu.models.registry import init_models as jax_init_models
    from csl_gan_tpu.ops import grads as jgops
    from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
    from csl_gan_tpu_torch import convert
    from csl_gan_tpu_torch.models.registry import init_models
    from csl_gan_tpu_torch.training.steps import StepBuilder

    bs = 8
    args = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-c", "0.5", "-bs",
            str(bs), "-tss", "80", "--manual_seed", "5", "--bf16", "true"]
    jopt = joptions.parse(args + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    assert jb.compute_dtype == jnp.bfloat16
    st = jb.init_state(Gv, Dv)
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (bs, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, bs).astype(np.int32)
    key = jax.random.PRNGKey(31)
    st_d, jdm = jax.jit(jb._d_step_gc)(st, jnp.asarray(x), jnp.asarray(y), None, None,
                                       jnp.asarray(x), jnp.asarray(y), key)
    kd = key_rows(key, 3)
    z = np.asarray(jb.gen_z(kd[0], bs))
    zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    noise = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
        kd[1], zeros_d, jb.sigma, st.clipping, per_layer=False)), "D")

    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    assert not toptions._k1_path(topt)
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    assert tb.compute_dtype == torch.bfloat16 and tb.use_ghost == jb.use_ghost
    host = jax.device_get(st)
    ts = convert.train_state_from_jax(
        host.d_params, host.g_params,
        (host.d_opt_state[0].mu, host.d_opt_state[0].nu, host.d_opt_state[0].count),
        (host.g_opt_state[0].mu, host.g_opt_state[0].nu, host.g_opt_state[0].count),
        host.clipping)
    ts, tdm = tb.d_step_gc(ts, torch.from_numpy(x), torch.from_numpy(y.astype(np.int64)),
                           torch.from_numpy(np.array(z)), noise=[noise[k] for k in tb.d_leaves])
    out = convert.train_state_to_jax(ts)
    want = jax.device_get(st_d)
    for a, b in ((want.d_params, out["d_params"]), (want.d_opt_state[0].mu, out["d_adam"][0])):
        for k in a:
            for leaf in a[k]:
                u, v = np.asarray(a[k][leaf], np.float64), np.asarray(b[k][leaf], np.float64)
                assert np.linalg.norm(u - v) / (np.linalg.norm(u) + 1e-12) < 2e-3, (k, leaf)
    for k in ("d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss"):
        np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=1e-4)


@pytest.mark.parametrize("extra", [[], ["--conditional", "-dpm", "gc"]])
def test_sub_epoch_log_rows_match_the_jax_trainer(tmp_path, extra):
    """MNIST -tss 160 -bs 32 --log_every 64: a row at batches 2 and 4 of each
    epoch (20% and 60%), as the JAX Trainer writes them; unconditional on
    the step runner, the conditional gc flagship on K1 by segments."""
    from csl_gan_tpu.training.loop import Trainer as JaxTrainer

    argv = ["MNIST", "-tss", "160", "-bs", "32", "--log_every", "64", "-ne", "2",
            "--manual_seed", "3"] + extra
    jt = JaxTrainer(joptions.parse(argv + ["-o", str(tmp_path / "j")]))
    jt.run()
    topt = toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path / "t")])
    tt = Trainer(topt)
    assert isinstance(tt.runner, EpochsRunner if extra else StepRunner)
    assert tt._epoch_cuts() == [2, 4, 5]
    tt.run()
    jrows, trows = _rows(tmp_path / "j" / "log.csv"), _rows(tmp_path / "t" / "log.csv")
    assert list(jrows[0]) == list(trows[0])
    assert [(r["Epoch"], float(r["Batch"])) for r in trows] == \
        [(r["Epoch"], float(r["Batch"])) for r in jrows] == \
        [("0", 20.0), ("0", 60.0), ("1", 20.0), ("1", 60.0)]
    for r in trows:
        assert all(np.isfinite(float(v)) for k, v in r.items() if not v.startswith("["))
    assert tt.state.d_count == 10
    if extra:
        jp, tp = (_rows(tmp_path / d / "privacy_log.csv") for d in ("j", "t"))
        assert [r["Epoch"] for r in tp] == [r["Epoch"] for r in jp] == ["0", "1"]
        np.testing.assert_allclose([float(r["Epsilon"]) for r in tp],
                                   [float(r["Epsilon"]) for r in jp], rtol=1e-12)


def test_host_loop_celeba_trains(tmp_path):
    out = tmp_path / "host"
    tr = Trainer(toptions.parse(CELEBA + ["--host_loop", "true", "--platform", "cpu",
                                          "-o", str(out)]))
    assert tr.host_loader is not None and not hasattr(tr, "images")
    assert isinstance(tr.runner, StepRunner) and tr.runner.loader is tr.host_loader
    tr.run()
    assert tr.state.d_count == 2
    (row,) = _rows(out / "log.csv")
    vals = [float(v) for k, v in row.items() if not v.startswith("[")]
    assert all(np.isfinite(vals))
    argv = CELEBA + ["--host_loop", "true", "--poisson", "true", "-o", str(tmp_path / "p")]
    with pytest.raises(Exception, match="--poisson requires an in-memory"):
        Trainer(toptions.parse(argv + ["--platform", "cpu"]))


def test_single_class_conditional_opt_txt_resumes(tmp_path):
    """n_classes has no flag: a loaded opt.txt brings it. The JAX package
    accepts a single-class conditional config (tests/test_options.py:
    120-127), and so does the port: it trains and resumes."""
    out = tmp_path / "one"
    opt = toptions.parse(MNIST + ["-ne", "1", "--log_every", "160", "--platform", "cpu",
                                  "-o", str(out)])
    opt.n_classes = 1
    toptions.derive_and_validate(opt)
    assert not toptions._k1_path(opt)
    tr = Trainer(opt)
    assert isinstance(tr.runner, StepRunner) and tr.D.lin1.in_features == 785
    tr.run()
    with open(out / "opt.txt") as f:
        assert json.load(f)["n_classes"] == 1
    ropt = toptions.parse(["MNIST", "-rp", str(out), "-re", "1", "-ne", "2", "-ka",
                           "n_epochs", "--platform", "cpu"])
    assert ropt.n_classes == 1
    rt = Trainer(ropt)
    assert rt.start_epoch == 1
    rt.run()
    assert rt.state.d_count == 10 and len(_rows(out / "log.csv")) == 2


def test_wasserstein_aux_on_the_vanilla_model_is_the_jax_error(tmp_path):
    from csl_gan_tpu.models.registry import init_models as jax_init_models
    from csl_gan_tpu_torch.models.registry import init_models

    argv = MNIST + ["--aux_loss_type", "wasserstein"]
    msg = "Cross entropy loss is the only aux loss supported for vanilla architecture."
    with pytest.raises(Exception, match=msg):
        (_, gv), (D, dv) = jax_init_models(joptions.parse(argv + ["-o", str(tmp_path / "j")]))
    with pytest.raises(Exception, match=msg) as err:
        init_models(toptions.parse(argv + ["--platform", "cpu", "-o", str(tmp_path / "t")]),
                    torch.device("cpu"))
    assert not isinstance(err.value, NotImplementedError)


def test_profile_writes_a_trace_and_the_summary(tmp_path, capsys):
    out = tmp_path / "prof"
    tr = Trainer(toptions.parse(MNIST + ["-ne", "1", "--log_every", "64", "-p",
                                         "--platform", "cpu", "-o", str(out)]))
    tr.run()
    printed = capsys.readouterr().out
    assert (out / "profile" / "trace.json").stat().st_size > 0
    assert "Self CPU time total" in printed
    assert "=== Training profile (per-section wall-clock) ===" in printed
    for section in ("segment_run", "accounting", "log_flush", "checkpoint"):
        assert section in printed, section
