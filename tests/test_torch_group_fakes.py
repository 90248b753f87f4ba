"""``--group_fakes`` (the cadence-grouped runner) on the port, on the CPU:

  - ``StepBuilder.batch_fakes`` (one (m * bs)-row G forward) against JAX
    ``batch_fakes`` on the same z, on the MNIST DCResNet G with converted
    params (fp32: reduction order only, held to 1e-5 relative l2);
  - one segment of 6 D steps on a narrow DCResNet (``n_d_steps`` 5: the
    head step, a full cadence group of 5, a G update after each) through
    the grouped runner against the port's per-batch runner from the same
    generator states: the same draws (the generators end in the same
    state), the same G updates, and params and Adam moments within 1e-4
    relative l2 (on the CPU the batched G forward sums in another order
    than the per-step one, ~1e-7 on the fakes, which the D steps carry on);
  - a segment that starts off the cadence takes the per-batch loop, one
    that starts on it the grouped one;
  - the gate (``grouped_runner_ok``): n_d_steps > 1, no Poisson under DP,
    a BatchNorm-free G, as the JAX package's.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.training.steps import TrainStepBuilder
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.steps import StepBuilder

BS = 8
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "--sigma", "0.5", "-bs", str(BS), "-tss", "80",
        "--train_d_until_threshold", "1e18", "--manual_seed", "4", "-ne", "1",
        "--log_every", "80"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(torch.linalg.norm(a - b) / (torch.linalg.norm(b) + 1e-12))


def test_batch_fakes_match_jax(tmp_path):
    jopt = options.parse(DCRN + ["--group_fakes", "true", "-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = jb.init_state(Gv, Dv)
    assert jb.grouped_runner_ok(True)
    m = 3
    rows = jax.vmap(lambda t: jax.random.fold_in(jax.random.PRNGKey(9), t))(
        jnp.arange(m))[:, None]
    ys = jax.random.randint(jax.random.PRNGKey(8), (m, BS), 0, 10)
    want = np.asarray(jb.batch_fakes(st, rows, ys))
    z = np.asarray(jax.vmap(lambda kk: jb.gen_z(kk[0], BS))(rows))

    topt = toptions.parse(DCRN + ["--group_fakes", "true", "--platform", "cpu",
                                  "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    assert tb.grouped_runner_ok(True)
    g_params = convert.params_from_jax(jax.device_get(st.g_params), "G")
    got = tb.batch_fakes(replace(tb.init_state(), g_params=g_params),
                         torch.from_numpy(np.array(z)), torch.from_numpy(np.array(ys, np.int64)))
    assert got.shape == want.shape == (m, BS, 28, 28, 1)
    assert _rel(got, torch.from_numpy(want)) < 1e-5
    # Slice j is step j's own forward.
    one = tb.fakes(g_params, torch.from_numpy(np.array(z[1])),
                   torch.from_numpy(np.array(ys[1], np.int64)))
    assert _rel(got[1], one) < 1e-5


def _trainer(tmp_path, tag, extra=()):
    return Trainer(toptions.parse(DCRN + list(extra) + ["--platform", "cpu",
                                                        "-o", str(tmp_path / tag)]))


def _segment(tr, start, cut):
    """Steps [start, cut) of the first epoch from the Trainer's generators;
    returns (state, sums, generator states after)."""
    r = tr.step_runner
    src = r.epoch_source(tr.gen_perm)
    sums = [{}, {}, 0]
    state = r.run_segment(tr.state, src, tr.gen, start, cut, sums, r.noise_stds(tr.state))
    return state, sums, (tr.gen.get_state(), tr.gen_perm.get_state())


def test_grouped_segment_matches_the_per_batch_runner(tmp_path):
    grouped = _trainer(tmp_path, "grouped", ["--group_fakes", "true"])
    plain = _trainer(tmp_path, "plain")
    assert grouped.step_runner.grouped and not plain.step_runner.grouped
    calls = []
    forward = grouped.builder.batch_fakes
    grouped.builder.batch_fakes = lambda st, z, y: calls.append(z.shape[0]) or forward(st, z, y)
    sg, sums_g, gens_g = _segment(grouped, 0, 6)
    sp, sums_p, gens_p = _segment(plain, 0, 6)
    assert calls == [1, 5]                      # the head step, then one cadence group
    assert all(torch.equal(a, b) for a, b in zip(gens_g, gens_p))   # the same draws
    assert sums_g[2] == sums_p[2] == 2 and sg.g_count == sp.g_count == 2
    assert sg.d_count == sp.d_count == 6
    for group in ("d_params", "d_mu", "d_nu", "g_params", "g_mu", "g_nu"):
        a, b = getattr(sg, group), getattr(sp, group)
        gap = _rel(torch.cat([a[k].ravel() for k in b]), torch.cat([b[k].ravel() for k in b]))
        assert gap < 1e-4, (group, gap)
    for key in ("d_adv_loss", "penalty", "norm_mean"):
        assert _rel(sums_g[0][key], sums_p[0][key]) < 1e-4, key


@pytest.mark.parametrize("start,grouped_calls", [(3, []), (5, [1, 4])])
def test_off_cadence_segments_take_the_per_batch_loop(tmp_path, start, grouped_calls):
    tr = _trainer(tmp_path, f"s{start}", ["--group_fakes", "true"])
    calls = []
    forward = tr.builder.batch_fakes
    tr.builder.batch_fakes = lambda st, z, y: calls.append(z.shape[0]) or forward(st, z, y)
    state, sums, _ = _segment(tr, start, 10 if start == 5 else 6)
    assert calls == grouped_calls
    assert state.d_count == (5 if start == 5 else 3)


@pytest.mark.parametrize("extra,ok", [
    (["--group_fakes", "true"], True),
    (["--group_fakes", "false"], False),
    (["--group_fakes", "true", "--n_d_steps", "1"], False),
    (["--group_fakes", "true", "--poisson", "true"], False),
    (["--group_fakes", "true", "-dpm", "is"], False),       # the BatchNorm G
])
def test_grouped_gate_is_the_jax_packages(tmp_path, extra, ok):
    tr = _trainer(tmp_path, "gate", extra)
    jopt = options.parse(DCRN + extra + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    jb.init_state(Gv, Dv)
    assert tr.step_runner.grouped == jb.grouped_runner_ok(jopt.use_dp) == ok
