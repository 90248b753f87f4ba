"""One DCResNet gc D step and one G step of the port (training/steps.py
``d_step_conv_ghost`` / ``g_step_dcresnet``) against the JAX package's
``_d_step_gc`` / ``_g_step``, on the CPU.

The config is the CelebA flagship's recipe on the MNIST DCResNet pair (the
CelebA-size convs take minutes to compile for the CPU): ACGAN with the
wasserstein aux loss, WGAN-GP on mean samples, Adam b1 0 / b2 0.9,
n_d_steps 5, and a clip bound low enough that most rows are clipped. The D's
conv2 is ghost-order, so the JAX side runs the Pallas K2/K3 in interpret mode
(FORCE, INTERPRET as tests/test_pallas_conv_ghost.py sets them) and the port
their plain versions. Every JAX draw is recomputed from the step's keys and
handed to the port: z (key row 0), the per-leaf DP noise (row 1), the
penalty's interpolation weights (row 2), the mean-sample picks, and the G
step's z and labels.

Tolerances. fp32: the two packages differ by reduction order only, so after
one Adam step params and moments agree to ~1e-6; they are held to the
normalized l2 gap of tests/test_pallas_epoch.py, < 2e-3. bf16: the packages
round at other places (torch adds a conv's bias inside the conv, XLA after
it; the JAX G's phase-form upsample-conv rounds pre-summed taps to bf16), so
activations differ by about one bf16 ulp (2^-8) on some elements, and the
gradients by what that rounding does to them. On this config each package's
own bf16 gradients differ from its fp32 ones by up to 1.8e-1 (G) and 4.5e-2
(D) in normalized l2, so the port's bf16 moments are held to the JAX
package's within 2.5e-1 (G) and 1e-1 (D) for mu, twice that for nu (the
squared gradient). With b1 = 0 the first Adam step moves each param by lr
times the sign of its gradient, so where rounding flips the sign of a small
gradient component the params differ by 2 lr: D params (none start at 0) are
held to 2e-2 in normalized l2, and G params, whose GroupNorm biases start at
0, to 2 lr elementwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csl_gan_tpu import options
from csl_gan_tpu.models.registry import init_models as jax_init_models
from csl_gan_tpu.ops import grads as jgops
from csl_gan_tpu.ops import pallas_conv_ghost as pcg
from csl_gan_tpu.privacy.mean_sampler import MeanSampler as JaxMeanSampler
from csl_gan_tpu.training.steps import TrainStepBuilder, key_rows
from csl_gan_tpu_torch import convert
from csl_gan_tpu_torch import options as toptions
from csl_gan_tpu_torch.models.registry import init_models
from csl_gan_tpu_torch.privacy.mean_sampler import MeanSampler
from csl_gan_tpu_torch.training.steps import StepBuilder

BS = 8
ARGS = ["MNIST", "--model", "DeepConvResNet", "--conditional", "-dpm", "gc",
        "--aux_loss_type", "wasserstein", "--penalty", "WGAN-GP", "-nms", "1",
        "--mean_sample_size", "4", "--n_d_steps", "5", "--adam_b1", "0",
        "--adam_b2", "0.9", "--sigma", "0.5", "-c", "0.05", "-bs", str(BS),
        "-tss", "64", "--train_d_until_threshold", "1e18", "--manual_seed", "5"]


@pytest.fixture(autouse=True)
def interpret_mode():
    old = pcg.FORCE, pcg.INTERPRET
    pcg.FORCE, pcg.INTERPRET = True, True
    yield
    pcg.FORCE, pcg.INTERPRET = old


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _l2rel(a, b):
    worst = 0.0
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x = np.asarray(x, np.float64).ravel()
        y = np.asarray(y, np.float64).ravel()
        worst = max(worst, float(np.linalg.norm(x - y) / (np.linalg.norm(x) + 1e-12)))
    return worst


def _mean_sample_picks(samples, y, key):
    """The JAX device sampler's surrogates, and the port's from the same
    draws (csl_gan_tpu/privacy/mean_sampler.py:126-136)."""
    jms = JaxMeanSampler(num_samples=samples.shape[1], mean_size=4, n_classes=10,
                         res=28, ch=1)
    want, _ = jms.device_sample_fn()(jnp.asarray(samples), key, jnp.asarray(y), BS)
    _, k2, k3, k4 = jax.random.split(key, 4)
    idx = jax.random.randint(k2, (BS,), 0, samples.shape[1])
    n_mean = jax.random.normal(k3, (BS, 1, 1, 1))
    n_pix = jax.random.normal(k4, (BS,) + samples.shape[2:])
    got = MeanSampler.pick(_t(samples), torch.tensor(np.asarray(y), dtype=torch.int64),
                           torch.tensor(np.asarray(idx), dtype=torch.int64),
                           _t(n_mean), _t(n_pix))
    return want, got


def test_mean_sample_picks_match_jax():
    rng = np.random.default_rng(1)
    samples = rng.uniform(-1, 1, (10, 3, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    want, got = _mean_sample_picks(samples, y, jax.random.PRNGKey(9))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_mean_sample_privacy_cost_matches_jax():
    kw = dict(noise_std=0.12, num_samples=1, mean_size=8, dataset_size=12800,
              res=64, ch=3, n_classes=2, smallest_class_size=5376)
    got = MeanSampler(**kw).get_privacy_cost(1e-6)
    want = JaxMeanSampler(**kw).get_privacy_cost(1e-6)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    assert got[1] == want[1]


@pytest.mark.parametrize("bf16", [False, True])
def test_d_and_g_step_match_jax(tmp_path, bf16):
    extra = ["--bf16", "true"] if bf16 else []
    jopt = options.parse(ARGS + extra + ["-o", str(tmp_path / "jax")])
    (G, Gv), (D, Dv) = jax_init_models(jopt)
    jb = TrainStepBuilder(jopt, G, D)
    assert jb.use_conv_ghost and jb.penalty_types == ["WGAN-GP"]
    st = jb.init_state(Gv, Dv)

    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (BS, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, BS).astype(np.int32)
    samples = rng.uniform(-1, 1, (10, 1, 28, 28, 1)).astype(np.float32)
    pen_x, pen_x_t = _mean_sample_picks(samples, y, jax.random.PRNGKey(21))

    # JAX reference: one D step, then one G step against the updated D.
    d_key, g_key = jax.random.PRNGKey(31), jax.random.PRNGKey(32)
    # (jitted: op-by-op dispatch of the penalty's double backward is slower
    # on the CPU than one compile.)
    st_d, jdm = jax.jit(jb._d_step_gc)(st, jnp.asarray(x), jnp.asarray(y), pen_x,
                                       jnp.asarray(y), jnp.asarray(x),
                                       jnp.asarray(y), d_key)
    st_g, jgm = jax.jit(jb._g_step)(st_d, g_key)

    # The draws of both steps, from the same keys.
    kd = key_rows(d_key, 3)
    z = jb.gen_z(kd[0], BS)
    zeros_d = jax.tree_util.tree_map(jnp.zeros_like, st.d_params)
    noise_tree = convert.params_from_jax(jax.device_get(jgops.add_gaussian_noise(
        kd[1], zeros_d, jb.sigma, st.clipping, per_layer=False)), "D")
    alpha = jax.random.uniform(jax.random.split(kd[2], 1)[0], (BS, 1, 1, 1))
    kg = key_rows(g_key, 2)
    z_g, y_g = jb.gen_z(kg[0], BS), jb.gen_y(kg[1], BS)

    # Port: the same state and draws on CPU tensors.
    topt = toptions.parse(ARGS + extra + ["--platform", "cpu", "-o", str(tmp_path / "port")])
    tG, tD = init_models(topt, torch.device("cpu"))
    tb = StepBuilder(topt, tG, tD)
    assert tb.use_conv_ghost
    host = jax.device_get(st)
    ts = convert.train_state_from_jax(
        host.d_params, host.g_params,
        (host.d_opt_state[0].mu, host.d_opt_state[0].nu, host.d_opt_state[0].count),
        (host.g_opt_state[0].mu, host.g_opt_state[0].nu, host.g_opt_state[0].count),
        host.clipping)
    yt = torch.tensor(y, dtype=torch.int64)
    noise = [noise_tree[k] for k in tb.d_leaves]
    ts, tdm = tb.d_step_conv_ghost(ts, _t(x), yt, _t(z), noise, pen_x_t, yt, [_t(alpha)])
    ts, tgm = tb.g_step_dcresnet(ts, _t(z_g), torch.tensor(np.asarray(y_g), dtype=torch.int64))
    out = convert.train_state_to_jax(ts)

    host_g = jax.device_get(st_g)
    # Most rows clipped: the clip factors are on the path being compared.
    assert float(np.mean(np.asarray(jdm["frac_clipped"]))) > 0.5
    d_tol, g_tol = (1e-1, 2.5e-1) if bf16 else (2e-3, 2e-3)
    assert _l2rel(host_g.d_params, out["d_params"]) < (2e-2 if bf16 else 2e-3)
    if bf16:
        lr = topt.g_lr
        for a, b in zip(jax.tree_util.tree_leaves(host_g.g_params),
                        jax.tree_util.tree_leaves(out["g_params"])):
            # (+ 1e-6: fp32 rounding of params near 1, the GroupNorm scales)
            assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 2 * lr + 1e-6
    else:
        assert _l2rel(host_g.g_params, out["g_params"]) < 2e-3
    assert _l2rel(host_g.d_opt_state[0].mu, out["d_adam"][0]) < d_tol
    assert _l2rel(host_g.d_opt_state[0].nu, out["d_adam"][1]) < 2 * d_tol
    assert _l2rel(host_g.g_opt_state[0].mu, out["g_adam"][0]) < g_tol
    assert _l2rel(host_g.g_opt_state[0].nu, out["g_adam"][1]) < 2 * g_tol
    assert int(host_g.d_opt_state[0].count) == out["d_adam"][2] == 1
    assert int(host_g.g_opt_state[0].count) == out["g_adam"][2] == 1

    rtol = 5e-2 if bf16 else 1e-4
    for k in ("d_adv_loss", "d_real_loss", "d_fake_loss", "penalty",
              "d_real_aux_loss"):
        np.testing.assert_allclose(float(tdm[k]), float(jdm[k]), rtol=rtol,
                                   atol=rtol * 1e-2, err_msg=k)
    for k in ("norm_mean", "norm_max"):
        assert _l2rel(np.asarray(jdm[k]), tdm[k].numpy()) < (2e-2 if bf16 else 1e-4), k
    for k in ("g_adv_loss", "g_aux_loss"):
        np.testing.assert_allclose(float(tgm[k]), float(jgm[k]), rtol=rtol,
                                   atol=rtol * 1e-2, err_msg=k)
