"""The D-step engines beside gc in the port's Trainer, on the CPU:

- the DCResNet's non-private D step (``d_step_plain``, BatchNorm G) against
  the JAX package's ``_d_step_plain`` with the JAX draws injected (z, the
  penalty's interpolation weights); fp32, held to < 2e-3 in normalized l2
  (params, Adam moments, the G's running averages) and 1e-4 relative
  (losses, penalty), the bounds of tests/test_torch_gc_step.py;
- for each new mode (is flat / per parameter / constant-pl / moving-avg-pl,
  tm, sv, and no DP on the DCResNet), a tiny CLI run whose ``log.csv`` header
  is the one the JAX Trainer writes for the same arguments (its
  ``build_logger``), with finite values, and whose ``privacy_log.csv``
  epsilon is the JAX accountant's (zCDP for tm / sv, RDP otherwise, plus the
  mean samples' cost);
- 1 + 1 resumed epochs of a DCResNet ``-dpm is -issm moving-avg-pl`` run
  bitwise equal to 2 (the scaling vector and the BatchNorm G's running
  averages go through the save);
- the combinations still outside the port raise, naming their flag.
A JAX save of a moving-avg-pl state read by the port's ``load_d`` is a case
of tests/test_torch_checkpoint.py.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.privacy import make_accountant as jax_make_accountant
from csl_gan_tpu.training.logger import build_logger as jax_build_logger
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch import train as port_train
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import StepRunner
from csl_gan_tpu_torch.training.steps import StepBuilder

# See tests/test_torch_trainer_basics.py: create ./output before any worker parses.
os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


BS = 8
TINY = ["MNIST", "--conditional", "--sigma", "0.7", "-bs", "32", "-tss", "160",
        "--manual_seed", "3"]


def _dcrn(tss: int):
    """tss / 10 rows a class, a mean sample of half of them."""
    return ["MNIST", "--model", "DeepConvResNet", "--conditional",
            "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
            "--mean_sample_size", str(tss // 20), "--n_d_steps", "5", "--adam_b1", "0",
            "--adam_b2", "0.9", "--sigma", "0.5", "-bs", str(BS), "-tss", str(tss),
            "--train_d_until_threshold", "1e18", "--manual_seed", "4"]


DCRN = _dcrn(80)
# The Trainer runs: five D steps an epoch, a G update after the first.
DCRN_SHORT = _dcrn(40)


def _l2rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        worst = max(worst, float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12)))
    return worst


def test_dcresnet_d_step_plain_matches_jax(tmp_path):
    jopt = options.parse(DCRN + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = jb.init_state(Gv, Dv)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)
    d_key = jax.random.PRNGKey(51)
    st_d, jdm = jax.jit(jb._d_step_plain)(st, jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(pen_x), jnp.asarray(y), d_key)
    kd = key_rows(d_key, 2)
    z = jb.gen_z(kd[0], BS)
    alpha = jax.random.uniform(jax.random.split(kd[1], 1)[0], (BS, 1, 1, 1))

    topt = toptions.parse(DCRN + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    assert tb.g_has_bn and jb.g_has_bn       # no per-sample grads: BatchNorm G
    host = jax.device_get(st)
    ts = convert.train_state_from_jax(
        host.d_params, host.g_params,
        (host.d_opt_state[0].mu, host.d_opt_state[0].nu, host.d_opt_state[0].count),
        (host.g_opt_state[0].mu, host.g_opt_state[0].nu, host.g_opt_state[0].count),
        host.clipping, g_batch_stats=host.g_batch_stats)
    assert sorted(ts.g_batch_stats) == sorted(tb.init_state().g_batch_stats)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    yt = torch.tensor(y, dtype=torch.int64)
    ts, tdm = tb.d_core(ts, t(x), yt, t(z), False, pen_x=t(pen_x), pen_y=yt,
                        alphas=[t(alpha)])
    out = convert.train_state_to_jax(ts)
    host_d = jax.device_get(st_d)
    assert _l2rel(host_d.d_params, out["d_params"]) < 2e-3
    assert _l2rel(host_d.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert _l2rel(host_d.d_opt_state[0].nu, out["d_adam"][1]) < 4e-3
    assert _l2rel(host_d.g_batch_stats, out["g_batch_stats"]) < 2e-3
    assert not np.allclose(out["g_batch_stats"]["BatchNorm_0"]["var"], 1.0)
    for k in ("d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss", "penalty"):
        np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


CLI = {
    "is": TINY + ["-dpm", "is"],
    "is-per-param": TINY + ["-dpm", "is", "-ispp", "true"],
    "is-constant-pl": TINY + ["-dpm", "is", "-issm", "constant-pl",
                              "-issv", "1", "2", "3", "4", "5", "6"],
    "is-moving-avg-pl": TINY + ["-dpm", "is", "-issm", "moving-avg-pl",
                                "--moving_avg_beta", "0.5"],
    "tm": TINY + ["-dpm", "tm"],
    "sv": TINY + ["-dpm", "sv"],
    "dcresnet-is": DCRN_SHORT + ["-dpm", "is"],
    "dcresnet-tm": DCRN_SHORT + ["-dpm", "tm"],
    "dcresnet-plain": DCRN_SHORT,
}


@pytest.mark.parametrize("name", list(CLI))
def test_mode_trains_with_the_jax_log_and_epsilon(tmp_path, name):
    args = CLI[name]
    tss = int(args[args.index("-tss") + 1])
    common = args + ["-ne", "1", "--log_every", str(tss)]
    jopt = options.parse(common + ["-o", str(tmp_path / "jax")])
    jax_build_logger(jopt, str(tmp_path / "jax_log.csv")).close()
    out = tmp_path / "port"
    tr = Trainer(toptions.parse(common + ["--platform", "cpu", "-o", str(out)]))
    assert isinstance(tr.runner, StepRunner)
    assert tr.run() == 0 and tr.state.d_count == tr.n_batches
    with open(tmp_path / "jax_log.csv") as f:
        want = next(csv.reader(f))
    with open(out / "log.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == want and len(rows) == 2
    row = dict(zip(rows[0], rows[1]))
    for k in ("D Adv Loss", "D Real Loss", "D Fake Loss", "D Real Aux Loss", "G Adv Loss"):
        assert np.isfinite(float(row[k])), k
    if jopt.dp_mode == "is":
        mean, lo, hi = (np.asarray(row[k].strip("[]").split(), np.float64)
                        for k in ("IS Mean", "IS Min", "IS Max"))
        assert mean.size == (len(tr.builder.d_leaves) if jopt.imm_sens_per_param else 1)
        assert np.all(lo <= mean + 1e-6) and np.all(mean <= hi + 1e-6) and np.all(lo >= 0)
        assert np.all(hi > 0)
    if not jopt.use_dp:
        assert not (out / "privacy_log.csv").exists()
        return
    with open(out / "privacy_log.csv") as f:
        eps = float(list(csv.DictReader(f))[-1]["Epsilon"])
    ref = jax_make_accountant(jopt)
    assert type(ref).__name__ == ("ZcdpAccountant" if jopt.dp_mode in ("tm", "sv")
                                  else "RdpAccountant")
    ref.step(tr.n_batches)
    np.testing.assert_allclose(eps - tr.mean_sample_privacy_cost,
                               ref.get_privacy_spent(jopt.delta)[0], rtol=1e-9)
    for p in list(tr.state.d_params.values()) + list(tr.state.g_params.values()):
        assert torch.isfinite(p).all()


def test_moving_avg_pl_resumes_bitwise(tmp_path):
    args = DCRN_SHORT + ["-dpm", "is", "-issm", "moving-avg-pl", "--log_every", "40",
                         "--platform", "cpu"]
    a, b = tmp_path / "a", tmp_path / "b"
    port_train.main(args + ["-ne", "2", "-o", str(a)])
    port_train.main(args + ["-ne", "1", "-o", str(b)])
    tr = Trainer(toptions.parse(["MNIST", "-rp", str(b), "-re", "1", "-ne", "2", "-ka",
                                 "n_epochs", "--platform", "cpu"]))
    first = Trainer(toptions.parse(args + ["-ne", "1", "-o", str(tmp_path / "c")])).state
    assert tr.start_epoch == 1 and tr.builder.g_has_bn
    assert not torch.equal(tr.state.scaling_vec, first.scaling_vec)
    assert not torch.equal(tr.state.g_batch_stats["BatchNorm_0.var"],
                           first.g_batch_stats["BatchNorm_0.var"])
    tr.run()
    for f in ("G-2", "D-2"):
        assert (a / "saves" / f).read_bytes() == (b / "saves" / f).read_bytes(), f
    for f in ("log.csv", "privacy_log.csv"):
        with open(a / f) as fa, open(b / f) as fb:
            assert fa.read() == fb.read(), f


@pytest.mark.parametrize("extra,flag", [
    (TINY + ["-dpm", "is", "--fsdp", "true"], "--fsdp"),
    (TINY + ["-dpm", "tm", "--poisson", "true"], "--poisson"),
    (TINY + ["-dpm", "is", "--bf16", "true"], "--bf16"),
    (TINY + ["-dpm", "sv", "-wd", "0.1"], "--weight_decay"),
    (DCRN + ["-dpm", "is", "--group_fakes", "true"], "--group_fakes"),
    (DCRN + ["-dpm", "tm", "--u8_table", "true"], "--u8_table"),
    (DCRN + ["-dpm", "is", "-gcm", "adaptive"], "--grad_clip_mode"),
    (DCRN + ["-dpm", "is", "--conditional_arch", "WCGAN", "--ref_pixel_shuffle", "true"],
     "--ref_pixel_shuffle"),
])
def test_unported_combinations_raise(tmp_path, extra, flag):
    """Flags outside the port raise naming themselves; ``--poisson`` outside
    gc is the JAX package's config error, in both packages. ``--fsdp``,
    ported since, has no effect on one rank: the is run equals the one
    without it bit for bit. The reference's
    pixel shuffle, ported since, parses and trains: the WCGAN is run's
    BatchNorm G upsamples so in every block, and its steps differ from the
    same run's without it. The single-device flags, ported since, hold their
    behaviour on these engines: ``--bf16`` on the vanilla is run and ``-wd``
    on sv train (the decay in sv's Adam); ``--group_fakes`` leaves the
    BatchNorm G of is per batch (the JAX gate); ``--u8_table`` stores the
    MNIST table as uint8 under tm; adaptive clipping outside gc is read by
    no step, so the is run equals the one without it bit for bit."""
    if flag == "--ref_pixel_shuffle":
        runs = []
        for tag, args in (("with", extra), ("without", extra[:-2])):
            tr = Trainer(toptions.parse(args + ["-ne", "1", "--platform", "cpu",
                                                "-o", str(tmp_path / tag)]))
            assert tr.builder.G.ResBlockUp_1.UpsampleConv_0.ref_ps == (tag == "with")
            tr.run()
            assert tr.state.g_count > 0
            assert all(bool(torch.isfinite(v).all()) for v in tr.state.g_params.values())
            runs.append(tr.state.g_params)
        assert any(not torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
        return
    if flag == "--poisson":
        for parse, argv in ((options.parse, extra),
                            (toptions.parse, extra + ["--platform", "cpu"])):
            with pytest.raises(Exception, match="only implemented for the gradient-clipping") as e:
                parse(argv + ["-o", str(tmp_path)])
            assert not isinstance(e.value, NotImplementedError)
        return
    if flag == "--fsdp":
        # Ported since: on one rank --fsdp has no effect (the JAX rule).
        runs = []
        for tag, args in (("with", extra), ("without", extra[:-2])):
            tr = Trainer(toptions.parse(args + ["-tss", "64", "-ne", "1", "--platform", "cpu",
                                                "-o", str(tmp_path / tag)]))
            assert not tr.mesh.fsdp
            tr.run()
            runs.append(tr.state.d_params)
        assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
        return
    if flag == "--grad_clip_mode":
        runs = []
        for tag, args in (("with", extra), ("without", extra[:-2])):
            tr = Trainer(toptions.parse(args + ["-tss", "40", "-ne", "1", "--platform", "cpu",
                                                "-o", str(tmp_path / tag)]))
            assert not tr.step_runner.adaptive and not isinstance(tr.state.clipping,
                                                                  torch.Tensor)
            tr.run()
            runs.append(tr.state.d_params)
        assert all(torch.equal(runs[0][k], runs[1][k]) for k in runs[0])
        return
    tr = Trainer(toptions.parse(extra + ["-ne", "1", "--platform", "cpu",
                                         "-o", str(tmp_path / "run")]))
    assert isinstance(tr.runner, StepRunner)
    if flag == "--group_fakes":
        assert tr.builder.g_has_bn and not tr.step_runner.grouped
    elif flag == "--u8_table":
        assert tr.table.dtype == torch.uint8 and tr.builder.labels_in_table
    else:
        assert tr.builder.weight_decay == (0.1 if flag == "--weight_decay" else 0.0)
        tr.run()
        assert tr.state.d_count == 5
        assert all(bool(torch.isfinite(v).all()) for v in tr.state.d_params.values())


def test_per_param_with_scaling_is_a_config_error(tmp_path):
    """The JAX package's rule: -ispp true takes no per-parameter scaling."""
    for parse in (options.parse, toptions.parse):
        with pytest.raises(Exception, match="per parameter"):
            parse(TINY + ["-dpm", "is", "-ispp", "true", "-issm", "constant-pl",
                          "-o", str(tmp_path)])
