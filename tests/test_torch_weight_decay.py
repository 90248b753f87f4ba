"""``-wd`` (L2 weight decay of D) on the port against the JAX package, on
the CPU:

  - D's Adam with decay (training/steps.py ``adam_update`` / ``_adam_all``)
    against JAX ``make_optimizers``' chain (add_decayed_weights,
    scale_by_adam, scale) over 3 updates of the same gradients;
  - one MNIST gc step (ghost route) and one small DCResNet gc step
    (two-pass route) with ``-wd`` against JAX ``_d_step_gc`` on converted
    params and the JAX step's own draws;
  - a ``-wd`` run's D save in the layout of the JAX package's decay chain,
    which the JAX checkpoint loader reads into a ``-wd`` state;
  - ``options._k1_path`` equal to ``pallas_epoch.supports`` with ``-wd``,
    ``--bf16`` and ``--u8_table`` (each leaves K1 for the step runner).

Tolerances. Adam alone: the same fp32 operations in the same order but for
the bias correction, which the port computes as 1 - exp(t ln b) in fp32 as
K1 does: 1e-6 relative. The steps: reduction order only, the bound of
tests/test_torch_gc_step.py (2e-3 normalized l2 on params and moments).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.training import checkpoint as jcheckpoint
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows, make_optimizers
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import pallas_epoch
from csl_gan_tpu_torch.training import checkpoint
from csl_gan_tpu_torch.training.loop import Trainer
from csl_gan_tpu_torch.training.segment_runner import EpochsRunner, StepRunner
from csl_gan_tpu_torch.training.steps import StepBuilder, _adam_all

BS = 8
WD = 0.05
MNIST = ["MNIST", "--conditional", "-dpm", "gc", "--sigma", "0.7", "-c", "0.5",
         "-bs", str(BS), "-tss", "80", "--manual_seed", "5"]
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "--sigma", "0.5", "-c", "0.05", "-bs", str(BS),
        "-tss", "80", "--train_d_until_threshold", "1e18", "--manual_seed", "5",
        "--conv_ghost", "false"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _l2rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        worst = max(worst, float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12)))
    return worst


@pytest.mark.parametrize("b1,b2", [(0.9, 0.999), (0.0, 0.9)])
def test_adam_with_decay_matches_optax_chain(tmp_path, b1, b2):
    opt = options.parse(MNIST + ["-wd", str(WD), "--adam_b1", str(b1), "--adam_b2", str(b2),
                                 "-o", str(tmp_path)])
    _, d_tx = make_optimizers(opt)
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = d_tx.init(jp)
    tp = {k: _t(v) for k, v in params.items()}
    mu = {k: torch.zeros_like(v) for k, v in tp.items()}
    nu = {k: torch.zeros_like(v) for k, v in tp.items()}
    for t in range(1, 4):
        g = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        upd, js = d_tx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, mu, nu = _adam_all(tp, {k: _t(v) for k, v in g.items()}, mu, nu, t,
                               opt.d_lr, b1, b2, wd=WD)
    adam = js[1]
    assert int(adam.count) == 3
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-8)
    # Decay moves the result: the same updates without it differ.
    p0 = {k: _t(v) for k, v in params.items()}
    no_wd, _, _ = _adam_all(p0, {k: torch.ones_like(v) for k, v in p0.items()},
                            {k: torch.zeros_like(v) for k, v in p0.items()},
                            {k: torch.zeros_like(v) for k, v in p0.items()}, 1, 0.1, b1, b2)
    wd, _, _ = _adam_all(p0, {k: torch.ones_like(v) for k, v in p0.items()},
                         {k: torch.zeros_like(v) for k, v in p0.items()},
                         {k: torch.zeros_like(v) for k, v in p0.items()}, 1, 0.1, b1, b2,
                         wd=5.0)
    assert not torch.equal(no_wd["a"], wd["a"])


@pytest.mark.parametrize("name", ["mnist-ghost", "dcresnet-two-pass"])
def test_gc_step_with_decay_matches_jax(tmp_path, name):
    args = (MNIST if name == "mnist-ghost" else DCRN) + ["-wd", str(WD)]
    dcresnet = name.startswith("dcresnet")
    jopt = options.parse(args + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = jb.init_state(Gv, Dv)
    # A state one Adam step in, so the decay meets non-zero moments.
    rng = np.random.default_rng(2)
    x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32) if dcresnet else None
    jpen = (jnp.asarray(pen_x), jnp.asarray(y)) if dcresnet else (None, None)
    step = jax.jit(jb._d_step_gc)
    st, _ = step(st, jnp.asarray(x), jnp.asarray(y), *jpen, jnp.asarray(x),
                 jnp.asarray(y), jax.random.PRNGKey(30))
    d_key = jax.random.PRNGKey(31)
    st_d, jdm = step(st, jnp.asarray(x), jnp.asarray(y), *jpen, jnp.asarray(x),
                     jnp.asarray(y), d_key)
    kd = key_rows(d_key, 3)
    z = jb.gen_z(kd[0], BS)
    zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    noise_tree = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
        kd[1], zeros_d, jb.sigma, st.clipping, per_layer=jb.per_layer)), "D")
    alpha = jax.random.uniform(jax.random.split(kd[2], 1)[0], (BS, 1, 1, 1))

    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    assert tb.weight_decay == WD
    assert (tb.use_ghost, tb.use_two_pass) == (jb.use_ghost, jb.use_two_pass)
    host = jax.device_get(st)
    d_adam, g_adam = host.d_opt_state[1], host.g_opt_state[0]      # the decay chain's Adam
    ts = convert.train_state_from_jax(host.d_params, host.g_params,
                                      (d_adam.mu, d_adam.nu, d_adam.count),
                                      (g_adam.mu, g_adam.nu, g_adam.count), host.clipping)
    yt = torch.tensor(y, dtype=torch.int64)
    pen = dict(pen_x=_t(pen_x), pen_y=yt, alphas=[_t(alpha)]) if dcresnet else {}
    noise = [noise_tree[k] for k in tb.d_leaves]
    out_ts, _ = tb.d_step_gc(ts, _t(x), yt, _t(z), noise=noise, **pen)
    out = convert.train_state_to_jax(out_ts)
    host_d = jax.device_get(st_d)
    assert _l2rel(host_d.d_params, out["d_params"]) < 2e-3
    assert _l2rel(host_d.d_opt_state[1].mu, out["d_adam"][0]) < 2e-3
    assert _l2rel(host_d.d_opt_state[1].nu, out["d_adam"][1]) < 4e-3
    assert int(host_d.d_opt_state[1].count) == out["d_adam"][2] == 2
    # Without the decay the port's step lands elsewhere, by more than the bound.
    tb.weight_decay = 0.0
    plain_ts, _ = tb.d_step_gc(ts, _t(x), yt, _t(z), noise=noise, **pen)
    assert _l2rel(host_d.d_opt_state[1].mu,
                  convert.train_state_to_jax(plain_ts)["d_adam"][0]) > 1e-2


def test_decay_save_has_the_jax_chain_layout(tmp_path):
    """A -wd run's D save holds the decay chain's optimizer state; the JAX
    checkpoint loader reads it into a -wd state, and the port resumes it."""
    out = tmp_path / "run"
    argv = MNIST + ["-wd", str(WD), "-ne", "1", "--log_every", "80", "--platform", "cpu"]
    tr = Trainer(toptions.parse(argv + ["-o", str(out)]))
    assert isinstance(tr.runner, StepRunner)
    tr.run()
    jopt = options.parse(MNIST + ["-wd", str(WD), "-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jst = TrainStepBuilder(jopt, G, D).init_state(Gv, Dv)
    jst, _, _ = jcheckpoint.load_d(str(out / "saves" / "D-1"), jst)
    adam = jax.device_get(jst.d_opt_state[1])
    assert int(adam.count) == tr.state.d_count == 10
    want = convert.params_to_jax(tr.state.d_mu, "D")
    assert _l2rel(want, adam.mu) == 0.0
    back, _, _, _ = checkpoint.load_d(str(out / "saves" / "D-1"), tr.state)
    assert back.d_count == 10 and all(torch.equal(back.d_nu[k], tr.state.d_nu[k])
                                      for k in back.d_nu)


@pytest.mark.parametrize("extra,on_k1", [
    ([], True),
    (["-wd", "1e-4"], False),
    (["--bf16", "true"], False),
    (["--u8_table", "true"], False),
    (["--u8_table", "true", "-dpm", "gc", "--pallas_epoch", "true"], False),
    (["--bf16", "false", "--u8_table", "false", "-wd", "0"], True),
])
def test_k1_path_equals_supports_on_the_surface_flags(tmp_path, extra, on_k1):
    opt = toptions.parse(MNIST + extra + ["--platform", "cpu", "-o", str(tmp_path)])
    tr = Trainer(opt)
    assert toptions._k1_path(opt) == pallas_epoch.supports(tr.builder, opt.use_dp, 1) == on_k1
    assert isinstance(tr.runner, EpochsRunner if on_k1 else StepRunner)
    if "--u8_table" in extra and on_k1 is False and "true" in extra:
        assert tr.table.dtype == torch.uint8 and not tr.builder.onehot_in_table
