"""The port's trimmed-mean / sign-vote engines (csl_gan_tpu_torch/ops/tmsv.py
and training/steps.py ``d_step_tmsv``) against the JAX package's
(csl_gan_tpu/ops/tmsv.py, ``_d_step_tmsv``), on the CPU, with the JAX draws
(N(0, 1) for the vote, Student-t(3) for the mean) handed to the port.

Tolerances. The aggregations sort, clip and sum the same fp32 values, so
the functions agree to 1e-6 relative. The D step's per-sample gradients
differ between the packages by reduction order only; params and Adam moments
after the step are held to < 2e-3 in normalized l2 (the bound of
tests/test_torch_gc_step.py) and the loss metrics to 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.ops import tmsv as jtmsv
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.ops import tmsv
from csl_gan_tpu_torch.training.steps import StepBuilder

BS = 8


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs six workers on a few cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _grads(seed, shape=(BS, 5, 3)):
    rng = np.random.default_rng(seed)
    g = rng.normal(0, 0.7, shape).astype(np.float32)
    g[:, 0, 0] = 0.0                    # exact zeros: sign 0
    return g


@pytest.mark.parametrize("rho", [0.1, 1.0, 25.0])
def test_sv_noise_std_matches_jax(rho):
    assert tmsv.sv_noise_std(rho) == jtmsv.sv_noise_std(rho)


def test_sign_vote_matches_jax():
    g = _grads(1)
    key = jax.random.PRNGKey(4)
    want = jtmsv.sign_vote(jnp.asarray(g), key, 0.5)
    noise = torch.tensor(np.asarray(jax.random.normal(key, g.shape[1:])))
    got = tmsv.sign_vote(torch.tensor(g), 0.5, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("m", [0, 1, 3, 10])
def test_trimmed_mean_sensitivity_matches_jax(m):
    m = min(m, (BS - 1) // 2)
    z = np.sort(np.clip(_grads(2), -1, 1), axis=0)
    want = jtmsv.trimmed_mean_sensitivity(jnp.asarray(z), m, 0.01, -1.0, 1.0)
    got = tmsv.trimmed_mean_sensitivity(torch.tensor(z), m, 0.01, -1.0, 1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("m", [1, 10])
def test_trimmed_mean_matches_jax(m):
    """m = 10 > (B - 1) // 2 takes the cap; values past +-1 are clipped."""
    g = _grads(3) * 2.0
    key = jax.random.PRNGKey(5)
    want = jtmsv.trimmed_mean(jnp.asarray(g), key, m, -1.0, 1.0, 0.01, 0.3)
    noise = torch.tensor(np.asarray(jax.random.t(key, 3.0, g.shape[1:])))
    got = tmsv.trimmed_mean(torch.tensor(g), m, -1.0, 1.0, 0.01, 0.3, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_generator_draws():
    """Without injected noise each function draws from the generator, on
    its device, reproducibly."""
    g = torch.tensor(_grads(6))
    for fn in (lambda gen: tmsv.sign_vote(g, 1.0, gen=gen),
               lambda gen: tmsv.trimmed_mean(g, 2, -1.0, 1.0, 0.01, 1.0, gen=gen)):
        a = fn(torch.Generator().manual_seed(9))
        b = fn(torch.Generator().manual_seed(9))
        c = fn(torch.Generator().manual_seed(10))
        assert torch.equal(a, b) and not torch.equal(a, c) and a.shape == g.shape[1:]


def test_student_t3_is_student_t3():
    """Z / sqrt(chi2_3 / 3) against scipy.stats.t(3): a KS test at a fixed
    seed (200,000 draws), and the known variance df / (df - 2) = 3 within
    the sampling error of a heavy-tailed draw."""
    t = tmsv.student_t3(torch.Generator().manual_seed(11), (200_000,)).numpy()
    ks = scipy.stats.kstest(t, scipy.stats.t(3).cdf)
    assert ks.pvalue > 0.01, ks
    assert abs(np.median(t)) < 0.01
    assert abs(np.var(t[np.abs(t) < 50]) - 3.0) < 0.3


MNIST = ["MNIST", "--conditional", "--sigma", "0.7", "-bs", str(BS), "-tss", "80",
         "--manual_seed", "5"]
DCRN = ["MNIST", "--model", "DeepConvResNet", "--conditional",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "-bs", str(BS), "-tss", "64",
        "--train_d_until_threshold", "1e18", "--manual_seed", "5"]


def _l2rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        worst = max(worst, float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12)))
    return worst


@pytest.mark.parametrize("mode", ["tm", "sv"])
@pytest.mark.parametrize("model", ["mnist", "dcresnet"])
def test_d_step_tmsv_matches_jax(tmp_path, model, mode):
    dcresnet = model == "dcresnet"
    args = (DCRN if dcresnet else MNIST) + ["-dpm", mode, "--tm_m", "2"]
    jopt = options.parse(args + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    st = jb.init_state(Gv, Dv)
    rng = np.random.default_rng(8)
    x = rng.uniform(-1.0 if dcresnet else 0.0, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    pen_x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)

    d_key = jax.random.PRNGKey(43)
    st_d, jdm = jax.jit(jb._d_step_tmsv)(st, jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(pen_x), jnp.asarray(y), d_key)
    kd = key_rows(d_key, 3)
    z = jb.gen_z(kd[0], BS)
    leaves, treedef = jax.tree_util.tree_flatten(st.d_params)
    keys = jax.random.split(kd[1], len(leaves))
    draw = (lambda k, l: jax.random.t(k, 3.0, l.shape)) if mode == "tm" else \
        (lambda k, l: jax.random.normal(k, l.shape))
    noise_tree = convert.params_from_jax(jax.device_get(jax.tree_util.tree_unflatten(
        treedef, [draw(k, l) for k, l in zip(keys, leaves)])), "D")
    alpha = jax.random.uniform(jax.random.split(kd[2], 1)[0], (BS, 1, 1, 1))

    topt = toptions.parse(args + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    assert (tb.tm_m, tb.tm_min_val, tb.tm_max_val, tb.rho_per_step) == \
        (jb.tm_m, jb.tm_min_val, jb.tm_max_val, jb.rho_per_step)
    assert not tb.g_has_bn and not jb.g_has_bn   # per-sample grads: GroupNorm G
    host = jax.device_get(st)
    ts = convert.train_state_from_jax(
        host.d_params, host.g_params,
        (host.d_opt_state[0].mu, host.d_opt_state[0].nu, host.d_opt_state[0].count),
        (host.g_opt_state[0].mu, host.g_opt_state[0].nu, host.g_opt_state[0].count),
        host.clipping)
    yt = torch.tensor(y, dtype=torch.int64)
    t = lambda a: torch.tensor(np.asarray(a, np.float32))  # noqa: E731
    pen = dict(pen_x=t(pen_x), pen_y=yt, alphas=[t(alpha)]) if dcresnet else {}
    ts, tdm = tb.d_step_tmsv(ts, t(x), yt, t(z), [noise_tree[k] for k in tb.d_leaves], **pen)
    out = convert.train_state_to_jax(ts)

    host_d = jax.device_get(st_d)
    assert _l2rel(host_d.d_params, out["d_params"]) < 2e-3
    assert _l2rel(host_d.d_opt_state[0].mu, out["d_adam"][0]) < 2e-3
    assert _l2rel(host_d.d_opt_state[0].nu, out["d_adam"][1]) < 4e-3
    assert int(host_d.d_opt_state[0].count) == out["d_adam"][2] == 1
    for k in ["d_adv_loss", "d_real_loss", "d_fake_loss", "d_real_aux_loss"] + \
            (["penalty"] if dcresnet else []):
        np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    for k in ("d_real_acc", "d_fake_acc", "d_real_aux_acc"):
        assert abs(float(tdm[k]) - float(jdm[k])) < 1e-3, k
