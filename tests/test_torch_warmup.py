"""The non-private warmup (``-wi``), ``reset_optimizers`` and the resume of
an adaptive clipping run, on the CPU:

  - ``StepBuilder.reset_optimizers`` against the JAX builder's;
  - two warmup steps of the port's ``StepRunner.warmup`` from the JAX
    state, with the JAX draws injected (batches, z, G labels, the penalty's
    batch and weights), against what the JAX Trainer's ``train_batch(...,
    use_dp=False)`` runs (the builder's ``d_step_plain``, then ``g_step`` on
    the n_d_steps cadence), then both resets: the vanilla ACGAN and the
    DCResNet with WGAN-GP. Params within 2e-3 in normalized l2 (the bound
    of tests/test_torch_gc_step.py; two steps in fp32, reduction order
    only), the loss metrics 1e-4 relative, Adam moments and counts exactly
    zero after the reset;
  - a ``-wi 2`` run on mean samples of each package through its Trainer
    with every step metric replaced by 1 (the port's on K1 after the
    warmup): the first log row counts the warmup steps as the
    JAX Trainer counts them (D stats (4 + 2) / 4, the next row 4 / 4), and
    privacy_log.csv counts none of them (the same epsilons);
  - a resumed adaptive run (1 + 1 epochs) equals the uninterrupted one bit
    for bit, the saved thresholds those of the last step.
"""

import csv
import os
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options as joptions
from csl_gan_tpu.training.loop import Trainer as JaxTrainer
from csl_gan_tpu.training.steps import key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch import train as port_train
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import StepRunner
from torch_conditional_cases import BS, STEP_DCRN, STEP_VANILLA, as_t, as_y, builders, l2rel

os.makedirs("output", exist_ok=True)


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


VANILLA = STEP_VANILLA + ["--conditional", "-dpm", "gc", "-nms", "1", "--mean_sample_size", "4",
                          "-wi", "2"]
DCRN = STEP_DCRN + ["--conditional", "-dpm", "gc", "-wi", "2"]


def test_reset_optimizers_matches_jax(tmp_path):
    jb, st, tb, ts = builders(tmp_path, VANILLA)
    # Moments and counts away from zero first.
    gen = torch.Generator().manual_seed(0)
    rand = lambda t: {k: torch.rand(v.shape, generator=gen) for k, v in t.items()}  # noqa: E731
    ts = replace(ts, d_mu=rand(ts.d_mu), d_nu=rand(ts.d_nu), g_mu=rand(ts.g_mu),
                 g_nu=rand(ts.g_nu), d_count=3, g_count=2)
    got = convert.train_state_to_jax(tb.reset_optimizers(ts))
    want = jax.device_get(jb.reset_optimizers(st))
    assert got["d_adam"][2] == got["g_adam"][2] == int(want.d_opt_state[0].count) == 0
    for mine, theirs in ((got["d_adam"], want.d_opt_state[0]), (got["g_adam"], want.g_opt_state[0])):
        for a, b in ((mine[0], theirs.mu), (mine[1], theirs.nu)):
            la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
            assert len(la) == len(lb) and all(np.array_equal(u, v) for u, v in zip(la, lb))
    # Params and clipping are kept.
    assert l2rel(got["d_params"], convert.train_state_to_jax(ts)["d_params"]) == 0
    assert got["clipping"] == convert.train_state_to_jax(ts)["clipping"]


@pytest.mark.parametrize("case", ["vanilla", "dcresnet"])
def test_two_warmup_steps_match_jax(tmp_path, case):
    args = VANILLA if case == "vanilla" else DCRN
    jb, st, tb, ts = builders(tmp_path, args)
    dcresnet = case == "dcresnet"
    rng = np.random.default_rng(4)
    batches, queue, pens = [], [], []
    for it in range(2):
        x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (BS, 28, 28, 1)).astype(np.float32)
        y = rng.integers(0, 10, BS).astype(np.int32)
        pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)
        kd, kg = jax.random.PRNGKey(40 + it), jax.random.PRNGKey(50 + it)
        jpen = (jnp.asarray(pen_x), jnp.asarray(y)) if dcresnet else (jnp.asarray(x),
                                                                      jnp.asarray(y))
        st, jdm = jb.d_step_plain(st, jnp.asarray(x), jnp.asarray(y), *jpen, kd)
        d_rows = key_rows(kd, 2)
        queue.append(jb.gen_z(d_rows[0], BS))
        alpha = jax.random.uniform(jax.random.split(d_rows[1], 1)[0], (BS, 1, 1, 1))
        pens.append((as_t(pen_x), as_y(y), [as_t(alpha)]) if dcresnet else (None, None, None))
        batches.append((as_t(x), as_y(y), jdm))
        if it % jb.opt.n_d_steps == 0:
            st, _ = jb.g_step(st, kg)
            g_rows = key_rows(kg, 2)
            queue += [jb.gen_z(g_rows[0], BS), jb.gen_y(g_rows[1], BS)]
    st = jb.reset_optimizers(st)

    runner = StepRunner(tb, 1, 1, None, False)
    draws = iter(queue)
    tb.gen_z = lambda gen, size, lead=(): as_t(next(draws))
    tb.gen_y = lambda gen, size, lead=(): as_y(next(draws))
    runner._surrogate_batch = lambda gen, size: batches.pop(0)[:2]
    pen_iter = iter(pens)
    runner._penalty_inputs = lambda gen, x, y, bs: next(pen_iter)
    d_metrics = []
    real_d_core = tb.d_core

    def d_core(*a, **k):
        assert a[4] is False          # use_dp
        out = real_d_core(*a, **k)
        d_metrics.append(out[1])
        return out
    tb.d_core = d_core
    jdms = [b[2] for b in batches]
    ts, d_sums, g_sums, g_count = runner.warmup(ts, torch.Generator(), 2)
    ts = tb.reset_optimizers(ts)
    assert g_count == (1 if dcresnet else 2) and ts.d_count == ts.g_count == 0
    assert not batches and next(draws, None) is None
    out = convert.train_state_to_jax(ts)
    h = jax.device_get(st)
    assert l2rel(h.d_params, out["d_params"]) < 2e-3
    assert l2rel(h.g_params, out["g_params"]) < 2e-3
    for k in ("d_adam", "g_adam"):
        assert all(not np.any(v) for v in jax.tree_util.tree_leaves(out[k][:2]))
    for tdm, jdm in zip(d_metrics, jdms):
        for key in ("d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss", "penalty"):
            if key in jdm:
                np.testing.assert_allclose(float(tdm[key]), float(jdm[key]), rtol=1e-4,
                                           atol=1e-6, err_msg=key)
    np.testing.assert_allclose(float(d_sums["d_adv_loss"]),
                               sum(float(m["d_adv_loss"]) for m in d_metrics), rtol=1e-6)


def _ones(metrics):
    return {k: (jnp.ones_like(v) if isinstance(v, jax.Array) else torch.ones_like(v))
            for k, v in metrics.items()}


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_warmup_steps_land_in_the_first_log_row(tmp_path):
    args = ["MNIST", "--conditional", "-dpm", "gc", "-nms", "2", "--mean_sample_size", "10",
            "-wi", "2", "-bs", "40", "-tss", "160", "-ne", "2", "--log_every", "160",
            "--manual_seed", "2"]
    jt = JaxTrainer(joptions.parse(args + ["-o", str(tmp_path / "jax")]))
    # The warmup's jitted steps, and the steps the epoch scan traces.
    for name in ("d_step_plain", "g_step", "_d_core", "_g_step"):
        f = getattr(jt.builder, name)
        setattr(jt.builder, name, lambda *a, f=f, **k: (lambda r: (r[0], _ones(r[1])))(f(*a, **k)))
    jt.run()
    tr = Trainer(toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")]))
    assert not isinstance(tr.runner, StepRunner)    # warmup on the step runner, then K1
    for name in ("d_step", "g_step"):      # K1's plain version runs them too
        f = getattr(tr.builder, name)
        setattr(tr.builder, name, lambda *a, f=f, **k: (lambda r: (r[0], _ones(r[1])))(f(*a, **k)))
    tr.run()
    jrows, rows = _rows(tmp_path / "jax" / "log.csv"), _rows(tmp_path / "port" / "log.csv")
    assert len(rows) == len(jrows) == 2 and list(rows[0]) == list(jrows[0])
    for mine, theirs in zip(rows, jrows):
        for k in mine:
            if k.startswith("D Adv") or k.startswith("G "):
                assert float(mine[k]) == float(theirs[k]), k
    assert float(rows[0]["D Adv Loss"]) == 1.5 and float(rows[1]["D Adv Loss"]) == 1.0
    assert float(rows[0]["G Adv Loss"]) == 1.0
    # The accountant counts no warmup step: 4 then 8 DP steps in both.
    jeps, eps = _rows(tmp_path / "jax" / "privacy_log.csv"), _rows(tmp_path / "port" /
                                                                  "privacy_log.csv")
    assert [r["Epoch"] for r in eps] == [r["Epoch"] for r in jeps] == ["0", "1"]
    np.testing.assert_allclose([float(r["Epsilon"]) for r in eps],
                               [float(r["Epsilon"]) for r in jeps], rtol=1e-12)
    assert tr.accountant.steps == jt.accountant.steps == 8
    # K1 started from the reset Adam counts.
    assert tr.state.d_count == tr.state.g_count == 8


RESUME = {
    "vanilla-adaptive-mean-samples": ["MNIST", "--conditional", "-dpm", "gc", "-gcm", "adaptive",
                                      "-nms", "1", "--mean_sample_size", "10", "-bs", "50",
                                      "-tss", "150", "--log_every", "150", "-wi", "2"],
    "dcresnet-adaptive-pl-public": ["MNIST", "--model", "DeepConvResNet", "--conditional",
                                    "-dpm", "gc", "--penalty", "WGAN-GP", "-gcm", "adaptive-pl",
                                    "-pss", "30", "-bs", "8", "-tss", "16", "--log_every", "16",
                                    "--n_d_steps", "2", "--train_d_until_threshold", "1e18"],
}


@pytest.mark.parametrize("name", list(RESUME))
def test_resumed_adaptive_run_is_bitwise_equal(tmp_path, name):
    common = RESUME[name] + ["--platform", "cpu", "--manual_seed", "3", "--save_every", "1"]
    a, b = tmp_path / "a", tmp_path / "b"
    port_train.main(common + ["-ne", "2", "-o", str(a)])
    port_train.main(common + ["-ne", "1", "-o", str(b)])
    tr = Trainer(toptions.parse(["MNIST", "-rp", str(b), "-re", "1", "-ne", "2", "-ka",
                                 "n_epochs", "--platform", "cpu"]))
    saved, _, _, _ = checkpoint.load_d(str(b / "saves" / "D-1"), tr.state)
    assert isinstance(tr.state.clipping, torch.Tensor)
    assert torch.equal(tr.state.clipping, saved.clipping)
    assert not torch.equal(tr.state.clipping, tr.builder.init_state().clipping)
    tr.run()
    for f in ("G-2", "D-2"):
        assert (a / "saves" / f).read_bytes() == (b / "saves" / f).read_bytes(), f
    for f in ("log.csv", "privacy_log.csv"):
        assert _rows(a / f) == _rows(b / f), f
    # The saved thresholds are the last step's, which the log sums.
    clip = convert.clipping_to_jax(tr.state.clipping)
    assert np.all(clip > 0) and np.all(np.isfinite(clip))
