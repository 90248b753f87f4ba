"""Configurations and checks shared by the tests of the port's unconditional
runs and CGAN / WCGAN / embedded-G variants (tests/test_torch_conditional_*.py):
the small step configs (STEP_VANILLA, STEP_DCRN) with the helpers that run a
JAX step and its port counterpart on the same state and draws, and the
Trainer configs (TINY, TRAIN_DCRN, CASES, ROUTES) with ``check_variant_epoch``."""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.privacy import make_accountant as jax_make_accountant
from csl_gan_tpu.privacy.mean_sampler import MeanSampler as JaxMeanSampler
from csl_gan_tpu.training.logger import build_logger as jax_build_logger
from csl_gan_tpu.training.steps import TrainStepBuilder
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import pallas_epoch
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import StepRunner
from csl_gan_tpu_torch.training.steps import StepBuilder

BS = 8
STEP_VANILLA = ["MNIST", "--sigma", "0.7", "-c", "0.5", "-bs", str(BS), "-tss", "80",
           "--manual_seed", "5"]
STEP_DCRN = ["MNIST", "--model", "DeepConvResNet", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0", "--adam_b2", "0.9",
        "--sigma", "0.5", "-c", "0.05", "-bs", str(BS), "-tss", "80",
        "--train_d_until_threshold", "1e18", "--manual_seed", "5"]
VARIANTS = {"uncond": [], "cgan": ["--conditional", "--conditional_arch", "CGAN"],
            "wcgan": ["--conditional", "--conditional_arch", "WCGAN"]}



def as_t(a):
    return None if a is None else torch.tensor(np.asarray(a, np.float32))


def as_y(a):
    return None if a is None else torch.tensor(np.asarray(a), dtype=torch.int64)


def as_j(a):
    return None if a is None else jnp.asarray(a)


def rel(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30))


def l2rel(a, b):
    return max(rel(y, x) for x, y in zip(jax.tree_util.tree_leaves(a),
                                          jax.tree_util.tree_leaves(b)))


def builders(tmp_path, args):
    """(JAX builder, JAX state, port builder, the port's copy of the state)."""
    jopt = options.parse(args + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = jb.init_state(Gv, Dv)
    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    h = jax.device_get(st)
    ts = convert.train_state_from_jax(
        h.d_params, h.g_params,
        (h.d_opt_state[0].mu, h.d_opt_state[0].nu, h.d_opt_state[0].count),
        (h.g_opt_state[0].mu, h.g_opt_state[0].nu, h.g_opt_state[0].count),
        h.clipping, g_batch_stats=h.g_batch_stats)
    return jb, st, tb, ts


def batch(opt, dcresnet, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32) if opt.conditional else None
    pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32) if dcresnet else x
    return x, y, pen_x


def assert_d_step(st_d, jdm, ts, tdm, penalty):
    out = convert.train_state_to_jax(ts)
    h = jax.device_get(st_d)
    assert l2rel(h.d_params, out["d_params"]) < 2e-3
    assert l2rel(h.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert l2rel(h.d_opt_state[0].nu, out["d_adam"][1]) < 4e-3
    assert int(h.d_opt_state[0].count) == out["d_adam"][2] == 1
    assert sorted(tdm) == sorted(jdm), (sorted(tdm), sorted(jdm))
    if "clipping" in jdm:
        np.testing.assert_array_equal(tdm["clipping"].numpy(), np.asarray(jdm["clipping"]))
    for k in ("d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss", "penalty"):
        if k in jdm:
            np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=1e-4, atol=1e-6,
                                       err_msg=k)
    for k in ("d_real_acc", "d_fake_acc", "d_real_aux_acc"):
        if k in jdm:
            assert abs(float(tdm[k]) - float(jdm[k])) < 1e-3, k
    assert ("penalty" in tdm) == penalty
    return out


TINY = ["MNIST", "--sigma", "0.7", "-bs", "32", "-tss", "160", "--manual_seed", "3"]
# The CelebA flagship's recipe on the MNIST DCResNet pair: 5 D steps of 8 rows.
TRAIN_DCRN = ["MNIST", "--model", "DeepConvResNet", "--aux_loss_type", "wasserstein",
              "--penalty", "WGAN-GP", "-nms", "1", "--mean_sample_size", "2", "--n_d_steps",
              "5", "--adam_b1", "0", "--adam_b2", "0.9", "--sigma", "0.5", "-bs", "8", "-tss",
              "40", "--train_d_until_threshold", "1e18", "--manual_seed", "4"]
ENGINES = {"gc": ["-dpm", "gc"], "is": ["-dpm", "is"], "tm": ["-dpm", "tm"],
           "sv": ["-dpm", "sv"], "nodp": []}
CASES = {f"vanilla-{v}-{e}": TINY + a + m for v, a in VARIANTS.items()
         for e, m in ENGINES.items()}
DCRN_VARIANTS = dict(VARIANTS, embed=["--conditional", "--g_label_emb_mode", "embed"])
CASES.update({f"dcresnet-{v}-{e}": TRAIN_DCRN + a + m for v, a in DCRN_VARIANTS.items()
              for e, m in ENGINES.items()})
# The gc routes beside each model's default (ghost, conv ghost) and the is
# variants beside the flat one, each with the builder flag its route sets.
FUSED = ["-dpm", "gc", "--pallas", "true", "--grad_clip_split", "false"]
ROUTES = {
    "vanilla-uncond-gc-fused": (TINY + FUSED, "fused_route"),
    "vanilla-wcgan-gc-fused": (TINY + VARIANTS["wcgan"] + FUSED, "fused_route"),
    "dcresnet-cgan-gc-two-pass": (
        TRAIN_DCRN + VARIANTS["cgan"] + ["-dpm", "gc", "--conv_ghost", "false"], "use_two_pass"),
    "dcresnet-wcgan-gc-fused": (
        TRAIN_DCRN + VARIANTS["wcgan"] + ["-dpm", "gc", "--conv_ghost", "false", "--bf16", "true",
                                          "--pallas", "true"], "fused_route"),
    "dcresnet-uncond-gc-materialized": (
        TRAIN_DCRN + ["-dpm", "gc", "--grad_clip_split", "false"], "materialized"),
    "vanilla-uncond-is-per-param": (TINY + ["-dpm", "is", "-ispp", "true"], "is_per_param"),
    "vanilla-cgan-is-constant-pl": (
        TINY + VARIANTS["cgan"] + ["-dpm", "is", "-issm", "constant-pl", "-issv", "1", "2", "3",
                                   "4"], "is_scaling_mode"),
    "dcresnet-wcgan-is-per-param": (
        TRAIN_DCRN + VARIANTS["wcgan"] + ["-dpm", "is", "-ispp", "true"], "is_per_param"),
    "dcresnet-uncond-is-constant-pl": (
        TRAIN_DCRN + ["-dpm", "is", "-issm", "constant-pl", "-issv", "1", "2", "3", "4", "5"],
        "is_scaling_mode"),
}
CASES.update({k: args for k, (args, _) in ROUTES.items()})


def check_variant_epoch(tmp_path, name):
    """One Trainer epoch of CASES[name] on the CPU against the JAX log header,
    accountant and mean sampler (see tests/test_torch_conditional_trainer.py)."""
    args = CASES[name]
    tss = int(args[args.index("-tss") + 1])
    common = args + ["-ne", "1", "--log_every", str(tss)]
    jopt = options.parse(common + ["-o", str(tmp_path / "jax")])
    jax_build_logger(jopt, str(tmp_path / "jax_log.csv")).close()
    out = tmp_path / "port"
    opt = toptions.parse(common + ["--platform", "cpu", "-o", str(out)])
    assert (opt.use_aux_loss, opt.is_acgan, opt.aux_penalty) == \
        (jopt.use_aux_loss, jopt.is_acgan, jopt.aux_penalty)
    tr = Trainer(opt)
    b = tr.builder
    # Only the conditional ACGAN vanilla run takes K1's epochs runner.
    assert isinstance(tr.runner, StepRunner)
    assert not pallas_epoch.supports(b, opt.use_dp, 1)
    if name in ROUTES:
        assert getattr(b, ROUTES[name][1]) not in (False, "standard")
    if opt.model == "Vanilla":
        assert tr.table.shape == (tss, 784 + (10 if opt.conditional else 0) + 1)
        assert b.onehot_in_table == opt.conditional
    assert (tr.fixed_y is None) == (not opt.conditional)
    assert tr.fixed_z.shape[0] == (opt.sample_num if not opt.conditional else
                                   opt.n_classes * max(1, opt.sample_num // opt.n_classes))
    assert tr.run() == 0
    n = tr.n_batches
    assert tr.state.d_count == n == tss // opt.batch_size
    assert tr.state.g_count == -(-n // opt.n_d_steps)
    with open(tmp_path / "jax_log.csv") as f:
        want = next(csv.reader(f))
    with open(out / "log.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == want and len(rows) == 2
    row = dict(zip(rows[0], rows[1]))
    for k, v in row.items():
        if k not in ("Epoch", "Batch"):
            assert np.all(np.isfinite(np.asarray(v.strip("[]").split(), np.float64))), k
    assert ("D Real Aux Loss" in row) == opt.use_aux_loss
    if opt.conditional and opt.conditional_arch == "WCGAN":
        assert float(row["D Real Aux Loss"]) == 0.0 and float(row["G Aux Loss"]) == 0.0
    for p in list(tr.state.d_params.values()) + list(tr.state.g_params.values()):
        assert torch.isfinite(p).all()
    assert (out / "saves" / "G-1").is_file() and (out / "saves" / "D-1").is_file()
    if not opt.use_dp:
        assert not (out / "privacy_log.csv").exists()
        return
    with open(out / "privacy_log.csv") as f:
        eps = float(list(csv.DictReader(f))[-1]["Epsilon"])
    ref = jax_make_accountant(jopt)
    ref.step(n)
    cost = 0.0
    if opt.num_mean_samples > 0:
        cond = opt.conditional
        cost, _ = JaxMeanSampler(
            noise_std=opt.mean_sample_noise_std, num_samples=1, mean_size=2, dataset_size=tss,
            res=28, ch=1, n_classes=10 if cond else 1,
            smallest_class_size=tss / 10 if cond else None).get_privacy_cost(opt.delta)
        assert tr.mean_sample_privacy_cost == pytest.approx(cost, rel=1e-12)
    np.testing.assert_allclose(eps, ref.get_privacy_spent(jopt.delta)[0] + cost, rtol=1e-9)
