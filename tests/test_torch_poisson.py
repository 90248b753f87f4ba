"""Exact Poisson subsampling (``--poisson``) of the port against the JAX
package's, on the CPU:

  - the draw: ``StepBuilder.poisson_pack`` on the inclusion vector JAX
    ``poisson_draw`` draws gives its rows, count and mask; the port's own
    draw is shape-consistent; ``cap`` clamps to the dataset (JAX
    tests/test_poisson.py:173);
  - one gc D step with a validity mask against JAX ``_d_step_gc`` on every
    route: vanilla ghost, conv ghost (K2/K3's plain versions), two-pass,
    materialized (also in chunks that do not divide the buffer), and
    materialized with ``--pallas`` (K6's plain version, at sigma 0);
  - the masked step equals the fixed batch of its valid rows, and masked
    rows have no influence (JAX tests/test_poisson.py:41-107);
  - ``-dpm is --poisson`` raises the JAX package's message;
  - a CLI run on each model.

Tolerances: the step at tests/test_torch_gc_step.py's bounds (params and
Adam moments 2e-3 in normalized l2, nu 4e-3; loss metrics 1e-4 relative,
accuracies 1e-3 percent), the clip statistics 2e-3 in normalized l2; the
port's masked step against its own fixed-batch step rtol 1e-5 (the JAX
test's bound); rows, counts and masks exactly.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.privacy import make_accountant as jax_make_accountant
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import StepRunner
from torch_conditional_cases import (BS, STEP_DCRN, STEP_VANILLA, TRAIN_DCRN, as_t, as_y,
                                     assert_d_step, builders)
from torch_dp_surface_cases import assert_stats, gc_pair

os.makedirs("output", exist_ok=True)

CAP = BS + 5


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_poisson_pack_matches_jax(tmp_path):
    jb, _, tb, _ = builders(tmp_path, STEP_VANILLA + ["--conditional", "-dpm", "gc",
                                                     "--poisson", "true"])
    n = 80
    assert (tb.poisson_q, tb.poisson_cap) == (jb.poisson_q, jb.poisson_cap) == (0.1, 8 + 23)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (n, 28, 28, 1)).astype(np.float32)
    labels = rng.integers(0, 10, n).astype(np.int32)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        jx, jy, jvalid = jb.poisson_draw(jnp.asarray(images), jnp.asarray(labels), key)
        incl = np.asarray(jax.random.bernoulli(key, jb.poisson_q, (n,)))
        idx, valid = tb.poisson_pack(torch.tensor(incl))
        assert idx.shape == valid.shape == (jb.poisson_cap,) and valid.dtype == torch.float32
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(images[idx.numpy()], np.asarray(jx))
        np.testing.assert_array_equal(labels[idx.numpy()], np.asarray(jy))
        assert int(valid.sum()) == int(incl.sum())
        # The included rows first, in row order.
        np.testing.assert_array_equal(idx[: int(incl.sum())].numpy(), np.nonzero(incl)[0])
    gen = torch.Generator().manual_seed(3)
    counts = []
    for _ in range(50):
        idx, valid = tb.poisson_draw(gen, n)
        c = int(valid.sum())
        assert valid[:c].eq(1).all() and valid[c:].eq(0).all()
        assert len(set(idx.tolist())) == tb.poisson_cap
        counts.append(c)
    assert 4 < np.mean(counts) < 12


def test_poisson_cap_clamped_to_dataset(tmp_path):
    """High sampling rates: cap clamps to train_set_size, and the draw stays
    shape-consistent."""
    opt = toptions.parse(["MNIST", "-dpm", "gc", "--poisson", "true", "-tss", "100", "-bs", "90",
                          "--platform", "cpu", "-o", str(tmp_path)])
    tr = Trainer(opt)
    b = tr.builder
    assert b.poisson_cap == 100
    idx, valid = b.poisson_draw(torch.Generator().manual_seed(0), 100)
    assert idx.shape == valid.shape == (100,)
    assert 0 < float(valid.sum()) <= 100


def _masked_batch(dcresnet, seed, junk=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (CAP, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, CAP).astype(np.int32)
    valid = (rng.uniform(size=CAP) < 0.7).astype(np.float32)
    valid[:2] = 1.0
    if junk is not None:
        x[valid == 0] = junk
    return x, y, valid


ROUTES = {
    "vanilla-ghost": (STEP_VANILLA + ["--conditional"], "use_ghost"),
    "vanilla-materialized": (STEP_VANILLA + ["-gcm", "constant-pl", "-cpl", "0.3", "0.05",
                                             "0.2", "0.04", "--grad_clip_split", "false"],
                             "materialized"),
    "vanilla-fused": (STEP_VANILLA + ["--conditional", "--pallas", "true", "--sigma", "0",
                                      "--grad_clip_split", "false"], "fused_route"),
    # A buffer of 13 rows in chunks of 5: the last chunk zero-padded.
    "vanilla-chunked": (STEP_VANILLA + ["--conditional", "--per_sample_chunk", "5"],
                        "materialized"),
    "dcresnet-conv-ghost": (STEP_DCRN + ["--conditional", "--aux_loss_type", "wasserstein"],
                            "use_conv_ghost"),
    "dcresnet-two-pass": (STEP_DCRN + ["--conditional", "--conditional_arch", "CGAN",
                                       "--conv_ghost", "false"], "use_two_pass"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_masked_d_step_gc_matches_jax(tmp_path, route):
    args, flag = ROUTES[route]
    dcresnet = "DeepConvResNet" in args
    jb, st, tb, ts = builders(tmp_path, args + ["-dpm", "gc", "--poisson", "true"])
    assert getattr(tb, flag) and (tb.use_ghost, tb.use_conv_ghost, tb.use_two_pass) == \
        (jb.use_ghost, jb.use_conv_ghost, jb.use_two_pass)
    x, y, valid = _masked_batch(dcresnet, 5, junk=0.5)
    y = y if jb.opt.conditional else None
    pen_x = np.random.default_rng(6).uniform(-1, 1, x.shape).astype(np.float32) \
        if dcresnet else None
    st_d, jdm, new, tdm = gc_pair(jb, st, tb, ts, x, y, pen_x, y, valid=valid)
    assert_d_step(st_d, jdm, new, tdm, dcresnet)
    assert_stats(jdm, tdm)


STEP_ROUTES = {"vanilla-ghost": STEP_VANILLA + ["--conditional"],
               "vanilla-materialized": STEP_VANILLA + ["--grad_clip_split", "false"],
               "dcresnet-conv-ghost": [a for a in STEP_DCRN if a != "WGAN-GP"]
               + ["--conditional"]}


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_masked_step_equals_fixed_batch_and_ignores_masked_rows(tmp_path, route):
    """At sigma 0: the step on a [cap] buffer whose first rows are valid
    equals the fixed-batch step on those rows (JAX test_poisson.py:41-61),
    and other values in the masked rows change nothing, metrics included
    (:64-83)."""
    args = STEP_ROUTES[route] + ["-dpm", "gc", "--sigma", "0"]
    assert "WGAN-GP" not in args
    _, _, tb, ts = builders(tmp_path / "p", args + ["--poisson", "true"])
    dcresnet = "DeepConvResNet" in args
    x, y, _ = _masked_batch(dcresnet, 7)
    y = as_y(y) if tb.conditional else None
    valid = torch.tensor([1.0] * BS + [0.0] * (CAP - BS))
    z = torch.from_numpy(np.random.default_rng(8).standard_normal((CAP, tb.latent))
                         .astype(np.float32))
    noise = [torch.zeros_like(ts.d_params[k]) for k in tb.d_leaves]
    masked, m1 = tb.d_step_gc(ts, as_t(x), y, z, noise=noise, valid=valid)
    y_f = None if y is None else y[:BS]
    fixed, m0 = tb.d_step_gc(ts, as_t(x[:BS]), y_f, z[:BS], noise=noise)
    for k in tb.d_leaves:
        torch.testing.assert_close(masked.d_params[k], fixed.d_params[k], rtol=1e-5, atol=1e-7)
    x2 = x.copy()
    x2[BS:] = 0.123
    y2 = None if y is None else torch.cat([y[:BS], torch.zeros(CAP - BS, dtype=y.dtype)])
    junk, m2 = tb.d_step_gc(ts, as_t(x2), y2, z, noise=noise, valid=valid)
    for k in tb.d_leaves:
        torch.testing.assert_close(junk.d_params[k], masked.d_params[k], rtol=1e-5, atol=1e-7)
    for k in ("d_real_loss", "d_real_acc", "d_fake_loss", "d_real_aux_acc"):
        if k in m1:
            torch.testing.assert_close(m2[k], m1[k], rtol=1e-5, atol=1e-7)
            torch.testing.assert_close(m0[k], m1[k], rtol=1e-5, atol=1e-6)


def test_poisson_requires_gc(tmp_path):
    for parse, extra in ((options.parse, []), (toptions.parse, ["--platform", "cpu"])):
        with pytest.raises(Exception, match="only implemented for the gradient-clipping") as e:
            parse(["MNIST", "--poisson", "true", "-dpm", "is", "-o", str(tmp_path)] + extra)
        assert not isinstance(e.value, NotImplementedError)


CLI = {"vanilla": ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-bs", "16",
                   "-tss", "80", "--manual_seed", "3"],
       "dcresnet": TRAIN_DCRN + ["--conditional", "-dpm", "gc"]}


@pytest.mark.parametrize("model", list(CLI))
def test_poisson_cli_run(tmp_path, model):
    """One epoch through the CLI on the step runner (K1's gate takes no
    Poisson run): the epoch keeps its n_batches steps, the log is finite,
    epsilon is the JAX accountant's."""
    args = CLI[model] + ["--poisson", "true", "-ne", "1"]
    tss = int(args[args.index("-tss") + 1])
    args += ["--log_every", str(tss)]
    opt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "p")])
    tr = Trainer(opt)
    assert isinstance(tr.runner, StepRunner) and tr.builder.poisson
    seen = []
    step = tr.builder.d_step_gc

    def spy(state, x, *a, valid=None, **k):
        seen.append((x.shape[0], None if valid is None else float(valid.sum())))
        return step(state, x, *a, valid=valid, **k)
    tr.builder.d_step_gc = spy
    tr.run()
    n = tss // opt.batch_size
    assert tr.state.d_count == n == len(seen)
    assert all(b == tr.builder.poisson_cap and v is not None for b, v in seen)
    with open(tmp_path / "p" / "log.csv") as f:
        row = list(csv.DictReader(f))[-1]
    for k, v in row.items():
        assert np.all(np.isfinite(np.asarray(v.strip("[]").split(), np.float64))), k
    with open(tmp_path / "p" / "privacy_log.csv") as f:
        eps = float(list(csv.DictReader(f))[-1]["Epsilon"])
    jopt = options.parse(args + ["-o", str(tmp_path / "j")])
    ref = jax_make_accountant(jopt)
    ref.step(n)
    np.testing.assert_allclose(eps - tr.mean_sample_privacy_cost,
                               ref.get_privacy_spent(jopt.delta)[0], rtol=1e-9)
